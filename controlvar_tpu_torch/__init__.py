"""controlvar_tpu_torch: the PyTorch/CUDA port of controlvar_tpu.

Module names mirror the JAX package (`config`, `ops.*`, `models.*`,
`eval.*`, `train.*`, `ckpt.*`, `data.*`, `native`), so each counterpart is
easy to find. The port imports torch, numpy and the standard library only
(and, inside functions of `data/` alone, PIL and cv2 to decode dataset
files). Its entry points run on `cuda` unless the caller passes
`device="cpu"`; with no GPU and no device they raise. The host-only data
classes take no device.

Public layouts follow the JAX package: images and f_hat are NHWC, q/k/v are
(B, H, L, hd), token ids are (B, pn*pn) integers.
"""
from controlvar_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
