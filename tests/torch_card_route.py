"""The card's dispatch on CPU tensors, for the tests: ``ops`` routes them as
it routes CUDA tensors, and each kernel wrapper (the flash and SSD
forwards and their backwards) is replaced by its plain version in
``kernels/ref.py``, counted like a launch.  What is left to test is the
dispatch and the ``torch.autograd.Function`` plumbing around the kernels.
Imports no JAX."""
from types import SimpleNamespace

from repro_torch.kernels import ops, ref


class PlainKernel:
    """Stands in for a kernel wrapper on the CPU: ``fn``, counted like a
    launch."""

    def __init__(self, fn):
        self.fn = fn
        self.launches = 0

    def __call__(self, *args, **kwargs):
        self.launches += 1
        return self.fn(*args, **kwargs)


def plain_flash(q, k, v, causal, window, with_lse=False):
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if with_lse:
        return out, ref.flash_attention_lse_ref(q, k, causal=causal,
                                                window=window)
    return out


def plain_flash_bwd(q, k, v, out, lse, grad_out, causal, window):
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, grad_out,
                                       causal=causal, window=window)


def plain_ssd(x, dt, A, B, C, chunk, h0, keep=False):
    y, final = ref.ssd_scan_ref(x, dt, A, B, C, chunk, h0=h0)
    return (y, final, ()) if keep else (y, final)


def plain_ssd_bwd(x, dt, A, B, C, h0, scratch, grad_y, grad_final, chunk):
    return ref.ssd_scan_bwd_ref(x, dt, A, B, C, h0, grad_y, grad_final,
                                chunk)


def route_as_on_the_card(monkeypatch):
    """Patch the dispatch and the four wrappers; returns their counted
    stand-ins as ``flash``, ``flash_bwd``, ``ssd`` and ``ssd_bwd``."""
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels import ssd_scan as ssd_module
    route = SimpleNamespace(
        flash=PlainKernel(plain_flash), flash_bwd=PlainKernel(plain_flash_bwd),
        ssd=PlainKernel(plain_ssd), ssd_bwd=PlainKernel(plain_ssd_bwd))
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_flash", route.flash)
    monkeypatch.setattr(flash_module, "flash_attention", route.flash)
    monkeypatch.setattr(flash_module, "flash_attention_bwd", route.flash_bwd)
    monkeypatch.setattr(ops, "_ssd", route.ssd)
    monkeypatch.setattr(ssd_module, "ssd_scan", route.ssd)
    monkeypatch.setattr(ssd_module, "ssd_scan_bwd", route.ssd_bwd)
    return route
