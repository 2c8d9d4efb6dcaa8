"""mmqg_tpu_torch -- question generation, serving and training, in PyTorch + CUDA.

A port of ``mmqg_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, beside
the JAX package, which stays the reference it is tested against. It keeps
the JAX package's module layout and its parameter layouts, and imports
neither ``jax`` nor anything of ``mmqg_tpu``: what it needs of the JAX
package's JAX-free modules (``Config``, ``QGDataset``, BLEU, the
pipelining helper) it keeps as its own copies. It serves (every decode
strategy, raw video, the daemon), evaluates and trains every configuration
of the JAX package's model (modes text / text_video / trimodal, the
attention or non-attention decoder, the conv-LSTM or R(2+1)D-18 video
encoder), with the int8 VGGish audio tower on the card as the JAX package
serves off the CPU:

    QGPipeline(...).generate(contexts, frames, audio, strategy="greedy")
    QGPipeline(...).shard()          # data-parallel over every visible card
    python -m mmqg_tpu_torch.train -c config.json [--device cpu]
    python -m mmqg_tpu_torch.train -c config.json --data-parallel [--zero1|--fsdp]
    python -m mmqg_tpu_torch.prepare -c config.json --stages saliency,glove,text,data
    python -m mmqg_tpu_torch.convert --config config.json --vggish ... [--dry-run]

Layout:
  pipeline.py       QGPipeline: pack requests, encode, decode, detokenise;
                    calibrate_audio_int8 (static int8 audio scales)
  staging.py        the serving batch's reused page-locked host blocks
                    and their asynchronous copies to the card
  decode.py         AV buckets, greedy decode_from_memories, decode_batch
  train.py          train and validate steps, Trainer, the training CLI
  optim.py          optax's optimizers and schedules, in optax's state layout
  checkpoint.py     reads and writes the JAX package's msgpack and orbax
                    checkpoints, asynchronously on a writer thread
  config.py         Config with the JAX package's config.json round trip
  prepare.py        the offline prepare CLI: saliency, GloVe, text, data
  convert.py        released VGGish / R(2+1)D-18 weights -> a checkpoint
  metrics.py        BLEU suite (standard and reference-compat)
  data/             vocab, GloVe, splits, WAV reading and writing,
                    subtitles, salient frames and audio, QGDataset
                    batches, the streaming loader and its native pack pool
  parallel/         data parallelism: the mesh, batch and ZeRO-1/FSDP
                    rules, model replicas for serving, the multi-process
                    runtime, the optimizer state and parameters split
                    over its processes
  utils/            pipelined host loops, profiling and NaN debugging,
                    the corpus audit, plots
  compat/           from_jax: JAX train-state pytree (numpy leaves) <->
                    modules; from_torchvision: r2plus1d_18 weights;
                    from_reference / to_reference: the reference PyTorch
                    model's four checkpoint artifacts <-> the pytrees
  models/           layers, text/video (conv-LSTM, R(2+1)D)/audio encoders,
                    the two decoders, the frame and audio frontends,
                    encode, loss
  ops/lstm.py       K1: LSTM sequence, CUDA kernel + plain version
  ops/attention.py  K2: tri-modal attention, CUDA kernel + plain version
  ops/lstm_train.py K4: trainable LSTM layer, CUDA forward and backward
                    kernels + plain versions, as an autograd Function
  ops/vggish.py     K3: VGGish conv2..conv6, and the int8 conv of the
                    serving audio tower, one CUDA kernel design + plain
                    versions
  ops/_build.py     nvcc build of csrc/*.cu into one ctypes library
  csrc/             the hand-written CUDA C++ kernels (sm_90a)

On CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""
