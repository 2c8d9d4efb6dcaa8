"""mmqg_tpu_torch -- the question-generation serving path in PyTorch + CUDA.

A port of ``mmqg_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, beside
the JAX package, which stays the reference it is tested against. It keeps
the JAX package's module layout and its parameter layouts, imports neither
``jax`` nor ``mmqg_tpu``, and runs the greedy serving path:

    QGPipeline(...).generate(contexts, frames, audio, strategy="greedy")

Layout:
  pipeline.py       QGPipeline: pack requests, encode, decode, detokenise
  decode.py         AV buckets, greedy decode_from_memories, decode_batch
  checkpoint.py     reads the JAX package's msgpack checkpoints (no flax)
  compat/from_jax   JAX parameter pytree (numpy leaves) -> modules
  models/           layers, text/video/audio encoders, decoder, encode
  ops/lstm.py       K1: LSTM sequence, CUDA kernel + plain version
  ops/attention.py  K2: tri-modal attention, CUDA kernel + plain version
  ops/_build.py     nvcc build of csrc/*.cu into one ctypes library
  csrc/             the hand-written CUDA C++ kernels (sm_90a)

On CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""
