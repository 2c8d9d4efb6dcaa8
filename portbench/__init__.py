"""The benchmark of ``mmqg_tpu_torch`` on one NVIDIA H100.

One command runs one cell once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of sits in files of its own, found by name:
``configs/<config>.json`` (a model configuration), ``mixes/<traffic>.json``
(a traffic mix: its driver's kind and parameters), ``workloads/<cell>.json``
(a cell: configuration, traffic, chips, why), ``traffic/<kind>.py`` (a
traffic kind's driver) and ``metrics/<metric>.py`` (a per-layer metric's
reader). ``BENCHMARK.json`` at the checkout's root says which metrics each
cell reports. The yardstick (weights and requests from the seed, FLOP and
byte counts, peaks, the trace reduction and the f32 reference that decides
``correct``) lives here too; of the port it takes only the system under
test.
"""
