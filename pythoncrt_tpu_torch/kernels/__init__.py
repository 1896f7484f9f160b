"""Hand-written CUDA kernels (csrc/) with their PyTorch wrappers."""


def dest(out, shape, dtype, device, who: str):
    """A wrapper's output tensor: ``out`` when the caller gave one (a
    contiguous tensor of this shape and dtype on ``device``, else
    ValueError), or a new one."""
    import torch

    if out is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    if out.device != device or out.dtype != dtype or tuple(out.shape) != tuple(shape) \
            or not out.is_contiguous():
        raise ValueError(f"{who}: out must be a contiguous {dtype} {tuple(shape)} tensor on "
                         f"{device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def on_card(t, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    plain twin); any other device is refused."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def into(out, res):
    """A plain twin's result ``res``, copied into ``out`` when the caller
    gave one (the CPU side of a wrapper's ``out``)."""
    if out is None:
        return res
    dest(out, res.shape, res.dtype, res.device, "out")
    return out.copy_(res)
