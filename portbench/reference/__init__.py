"""Plain PyTorch references of what the cells run, in float32 with TF32
off. They import neither ``jax`` nor ``repro`` nor anything of
``repro_torch``, and take nothing the program made: they regenerate the
weights from the seed (``portbench.weights``) and read the program's
outputs only to judge them."""
