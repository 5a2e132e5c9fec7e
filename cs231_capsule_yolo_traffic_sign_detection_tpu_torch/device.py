"""Device selection and float32 precision policy, in one place.

Every entry point of the package takes an explicit ``device`` that
defaults to ``"cuda"``.  Asking for CUDA on a machine without a card
raises: nothing falls back to the CPU on its own.  The CPU is used only
when a caller asks for it (the tests do).

Precision: cuDNN runs float32 convolutions in TF32 unless told not to,
which drifts about 1e-3 from the JAX reference.  `resolve_device`
turns TF32 off for convolutions and matrix products whenever it hands
out a CUDA device, and `keep_f32` does the same for the serving entries
(export.py) whenever a model they are given is on a card, so the f32
path is full float32.
"""

import torch


def resolve_device(device="cuda"):
    """``"cuda"``/``"cpu"`` (or a torch.device) -> torch.device.

    Raises RuntimeError when CUDA is asked for and absent.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU")
        _tf32_off()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda | cpu")
    return dev


def _tf32_off():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def keep_f32(*modules):
    """Turn TF32 off, as `resolve_device` does, when any parameter of
    ``modules`` is on a card: a model moved there with ``.cuda()`` serves
    in full float32 too."""
    if any(p.is_cuda for m in modules for p in m.parameters()):
        _tf32_off()


def compute_dtype(name):
    """--dtype spelling -> torch dtype: float32 | bfloat16 (and aliases)
    | int8, the quantized serving path (ops/quant.py), which training
    refuses."""
    name = str(name or "float32").lower()
    if name in ("float32", "f32"):
        return torch.float32
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    if name == "int8":
        return torch.int8
    raise ValueError(f"unknown compute dtype {name!r}: float32 | bfloat16 "
                     "| int8")


def module_dtype(name):
    """The dtype a module is built in for --dtype ``name``: int8 serving
    builds f32 modules and quantizes them after the restore (the JAX
    registry's rule); the classifier of an int8 pipeline that is not
    quantized (CapsuleNet, or any on the host path) serves f32."""
    dtype = compute_dtype(name)
    return torch.float32 if dtype == torch.int8 else dtype
