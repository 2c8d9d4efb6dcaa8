"""mmqg_tpu_torch -- question generation, serving and training, in PyTorch + CUDA.

A port of ``mmqg_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, beside
the JAX package, which stays the reference it is tested against. It keeps
the JAX package's module layout and its parameter layouts and imports no
``jax``. The serving path imports nothing of ``mmqg_tpu``; the trainer
imports its JAX-free ``Config``, ``QGDataset``, BLEU metrics and
pipelining helper. It runs the greedy serving path and training:

    QGPipeline(...).generate(contexts, frames, audio, strategy="greedy")
    python -m mmqg_tpu_torch.train -c config.json [--device cpu]

Layout:
  pipeline.py       QGPipeline: pack requests, encode, decode, detokenise
  decode.py         AV buckets, greedy decode_from_memories, decode_batch
  train.py          train and validate steps, Trainer, the training CLI
  optim.py          optax's optimizers and schedules, in optax's state layout
  checkpoint.py     reads and writes the JAX package's msgpack checkpoints
  compat/from_jax   JAX train-state pytree (numpy leaves) <-> modules
  models/           layers, text/video/audio encoders, decoder, encode, loss
  ops/lstm.py       K1: LSTM sequence, CUDA kernel + plain version
  ops/attention.py  K2: tri-modal attention, CUDA kernel + plain version
  ops/lstm_train.py K4: trainable LSTM layer, CUDA forward and backward
                    kernels + plain versions, as an autograd Function
  ops/_build.py     nvcc build of csrc/*.cu into one ctypes library
  csrc/             the hand-written CUDA C++ kernels (sm_90a)

On CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""
