"""Subtitle parsing (.srt / .vtt) and a span's context
(``mmqg_tpu/data/subtitles.py``): hermetic parsers, a malformed cue
skipped, a VTT caption's end read from its own end time, and the captions
that overlap an answer span joined as its context. The corpus builders
stay in the JAX package."""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from mmqg_tpu_torch.data.text_prep import lowercase_subtitle

_TS_RE = re.compile(
    r"(?:(\d+):)?(\d{1,2}):(\d{2})[.,](\d{3})"
)  # [HH:]MM:SS,mmm (srt) or [HH:]MM:SS.mmm (vtt)


@dataclass
class Caption:
    start: float  # seconds
    end: float
    text: str


def _parse_ts(ts: str) -> Optional[float]:
    """Seconds, or None for a malformed timestamp (the caller skips the
    cue: one bad cue must not abort a whole file)."""
    m = _TS_RE.search(ts)
    if not m:
        return None
    hh = int(m.group(1) or 0)
    return (hh * 3600 + int(m.group(2)) * 60 + int(m.group(3))
            + int(m.group(4)) / 1000.0)


def parse_srt(text: str) -> List[Caption]:
    captions: List[Caption] = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = [ln.strip("﻿").rstrip("\r") for ln in block.splitlines()
                 if ln.strip()]
        if not lines:
            continue
        # optional numeric index line
        if "-->" not in lines[0] and len(lines) >= 2 and "-->" in lines[1]:
            lines = lines[1:]
        if "-->" not in lines[0]:
            continue
        start_s, end_s = [p.strip() for p in lines[0].split("-->")[:2]]
        body = "\n".join(lines[1:])
        start, end = _parse_ts(start_s), _parse_ts(end_s)
        if start is None or end is None:
            continue
        captions.append(Caption(start, end, body))
    return captions


def parse_vtt(text: str) -> List[Caption]:
    captions: List[Caption] = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = [ln.strip("﻿").rstrip("\r") for ln in block.splitlines()
                 if ln.strip()]
        if not lines or lines[0].startswith(("WEBVTT", "NOTE", "STYLE",
                                             "REGION")):
            continue
        if "-->" not in lines[0] and len(lines) >= 2 and "-->" in lines[1]:
            lines = lines[1:]  # cue identifier line
        if "-->" not in lines[0]:
            continue
        # vtt allows settings after the end timestamp
        start_s, rest = lines[0].split("-->")
        end_s = rest.strip().split(" ")[0]
        body = "\n".join(lines[1:])
        start, end = _parse_ts(start_s), _parse_ts(end_s)
        if start is None or end is None:
            continue
        captions.append(Caption(start, end, body))
    return captions


def parse_subtitle_file(path: Path) -> List[Caption]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    if str(path).endswith(".vtt") or text.lstrip("﻿").startswith("WEBVTT"):
        return parse_vtt(text)
    return parse_srt(text)


def is_important(answer_start: float, answer_end: float, start: float,
                 end: float) -> bool:
    """Whether a caption [start, end] overlaps the answer span."""
    return (answer_start <= start <= answer_end
            or answer_start <= end <= answer_end
            or start <= answer_start <= end)


def span_seconds(mmss: str) -> int:
    """'M:SS' or 'MM:SS' -> seconds."""
    m, s = mmss.split(":")
    return int(m) * 60 + int(s)


def extract_context(captions: List[Caption], answer_start: float,
                    answer_end: float) -> Optional[str]:
    """The cleaned captions that overlap the answer span, space-joined;
    None when there are none."""
    sentences = []
    for cap in captions:
        subtitle = lowercase_subtitle(cap.text)
        if subtitle and is_important(answer_start, answer_end, cap.start,
                                     cap.end):
            sentences.append(subtitle)
    return " ".join(sentences) if sentences else None
