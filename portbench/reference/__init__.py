"""The plain reference that decides ``correct``: the model's equations in
float32 PyTorch with TF32 off (``model.py``), and the raw inputs worked
out again from what both sides were handed (``inputs.py``). It imports
nothing of ``mmqg_tpu_torch``, ``mmqg_tpu`` or ``jax``."""
