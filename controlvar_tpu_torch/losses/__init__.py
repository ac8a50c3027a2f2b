from controlvar_tpu_torch.losses.vqperceptual import VQLPIPSWithDiscriminator  # noqa: F401
