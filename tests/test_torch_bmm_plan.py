"""`kernels.ordered_bmm`'s launch plan on the CPU: the route is a pure
function of the shape, and the strides the kernel is given address every
element of a and b as the product reads them, without a copy where the
attention's permuted keys and values lie as fp32.  The kernel itself runs
only on the card (tests/test_torch_cuda.py)."""
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ordered_bmm as OB


@pytest.mark.parametrize("shape,want", [
    ((1, 4, 1024, 1), "row"), ((1, 512, 1024, 1), "row"),
    ((4, 1, 64, 4096), "small"), ((32, 2, 128, 160), "small"),
    ((32, 16, 128, 160), "small"), ((32, 17, 128, 160), "tile64x64"),
    ((32, 64, 192, 128), "tile64x64"), ((32, 256, 256, 128), "tile128x64"),
    ((32, 256, 128, 256), "tile128x64"), ((32, 1500, 1500, 64), "tile128x64"),
    ((1, 300, 70, 131), "tile128x64")])
def test_route_follows_the_shape_alone(shape, want):
    assert OB.route(*shape) == want
    assert all(OB.route(*shape) == want for _ in range(3))


def _gathered(t, s, N1, N2, R, C):
    """The (N1 * N2, R, C) matrices that strides `s` address in t's
    storage."""
    return torch.as_strided(t, (N1, N2, R, C), s, t.storage_offset()).reshape(
        N1 * N2, R, C)


def _layouts():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    B, S, H, hd, G = 2, 9, 3, 8, 2
    k, v = r(B, S, H, hd), r(B, S, H, hd)
    cache = r(B, S + 4, H, hd)
    return {
        "keys": (r(B, H, G, hd), k.permute(0, 2, 3, 1)),
        "values": (r(B, H, G, S), v.permute(0, 2, 1, 3)),
        "keys of a longer cache": (r(B, H, 5, hd),
                                   cache[:, :S].permute(0, 2, 3, 1)),
        "shared b": (r(3, 4, 6), r(6, 5)),
        "norm": (r(2, 7, 12) ** 2, torch.ones(12, 1)),
        "broadcast b": (r(2, 3, 4, 6), r(3, 6, 5)),
        "broadcast a": (r(3, 4, 6), r(2, 3, 6, 5)),
        "pitched a": (r(3, 4, 10)[..., :6], r(3, 6, 5)),
        "three batch dims": (r(2, 3, 2, 4, 6),
                             r(2, 2, 3, 6, 5).permute(0, 2, 1, 3, 4)),
        "ssd readout": (r(4, 8)[:, None, :],
                        r(4, 8, 3, 5).permute(0, 2, 1, 3).reshape(4, 8, 15)),
        "bf16 keys": (r(B, H, G, hd).bfloat16(),
                      k.bfloat16().permute(0, 2, 3, 1)),
    }


@pytest.mark.parametrize("name", list(_layouts()))
def test_plan_strides_address_the_operands(name):
    a, b = _layouts()[name]
    p = OB.plan(a, b)
    want_a = a.float().expand(*torch.broadcast_shapes(
        a.shape[:-2], b.shape[:-2]), *a.shape[-2:]) if b.dim() > 2 else \
        a.float().reshape(1, -1, a.shape[-1])
    want_b = b.float().expand(*want_a.shape[:-2], *b.shape[-2:]) \
        if b.dim() > 2 else b.float()[None]
    N = p.N1 * p.N2
    assert (p.M, p.K, p.P) == (want_a.shape[-2], a.shape[-1], b.shape[-1])
    assert torch.equal(_gathered(p.a, p.sa, p.N1, p.N2, p.M, p.K),
                       want_a.reshape(N, p.M, p.K))
    assert torch.equal(_gathered(p.b, p.sb, p.N1, p.N2, p.K, p.P),
                       want_b.reshape(N, p.K, p.P))
    assert p.route == OB.route(N, p.M, p.K, p.P)


@pytest.mark.parametrize("name", ["keys", "values", "keys of a longer cache",
                                  "norm", "broadcast b", "pitched a"])
def test_attention_views_need_no_copy(name):
    """fp32 operands whose batch dims merge into two are read where they
    lie: the keys' and values' permuted views of the cache, a slice of a
    longer cache, a broadcast b, a padded row pitch."""
    a, b = _layouts()[name]
    p = OB.plan(a, b)
    assert p.a.data_ptr() == a.data_ptr() and p.b.data_ptr() == b.data_ptr()


def test_launch_passes_the_kernel_signature(monkeypatch):
    """`launch` hands the C entry point every argument of its ctypes
    signature but the stream, in order, and counts one launch."""
    from repro_torch.kernels import dispatch
    seen = []
    monkeypatch.setattr(build, "launch",
                        lambda name, dev, *args: seen.append((name, args)))
    dispatch.reset_counts()
    a, b = _layouts()["keys"]
    p = OB.plan(a, b)
    out = OB.launch(p)
    (name, args), = seen
    assert name == "ordered_bmm" and out.shape == (p.N1 * p.N2, p.M, p.P)
    assert len(args) == len(build.SIGNATURES["ordered_bmm"][1]) - 1
    assert args[3:9] == (OB.ROUTES[p.route], p.N1, p.N2, p.M, p.K, p.P)
    assert args[9:] == p.sa + p.sb
    assert dict(dispatch.LAUNCHES) == {"ordered_bmm": 1}
