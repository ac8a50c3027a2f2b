from controlvar_tpu_torch.parallel.mesh import make_mesh, param_shardings  # noqa: F401
