"""The plain reference of the benchmark's `correct`: ControlVAR's forward,
loss and gradients, AdamW, and the multi-scale VQVAE, in plain PyTorch
written from the published description (lxa9867/ControlVAR's
models/control_var.py and basic_var.py; FoundationVision/VAR's
basic_vae.py and quant.py), without kernels, caches or batching.

It runs in fp32 with TF32 off (`exact`), or, as the control of the
comparison, with every weight product (linear layers and convolutions)
taken in fp8 (`Prec("fp8")`). It imports torch alone: nothing of the
program, nothing that the program made.
"""
