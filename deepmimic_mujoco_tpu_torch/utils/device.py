"""Device selection for the port's entry points."""
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises for a CUDA device when no
    card is present, so a run never drifts onto the CPU unasked (the
    tests pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain torch path on the CPU")
    return dev


def fp32_physics() -> None:
    """Keep float32 matmuls in full float32 on the card (no TF32).

    The physics path is fp32 throughout: on the TPU, bf16 rounding of
    matmul inputs gave up to 3.4e-2 error in com-stage quantities; TF32
    is the same trap on the H100."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def const(m, key, make, device, dtype=None) -> torch.Tensor:
    """Tensor of a static model-derived array, built once per device.

    ``make()`` returns the numpy array; the tensor is cached on the
    model object under ``(key, device, dtype)``, so the per-step physics
    does no host-to-device copies of static tables."""
    cache = m.__dict__.setdefault("_torch_consts", {})
    k = (key, str(device), dtype)
    t = cache.get(k)
    if t is None:
        t = torch.as_tensor(make(), device=device)
        if dtype is not None:
            t = t.to(dtype)
        cache[k] = t
    return t
