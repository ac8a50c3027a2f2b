"""Checkpoints of the PyTorch port: import and export of reference .pth
state dicts, train-state save/restore, VAR -> ControlVAR surgery, LoRA and
the download helper."""
from controlvar_tpu_torch.ckpt.torch_import import (  # noqa: F401
    convert_control_var_state_dict,
    convert_var_state_dict,
    convert_vqvae_state_dict,
    load_torch_state_dict,
)
