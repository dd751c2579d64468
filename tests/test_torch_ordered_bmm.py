"""`kernels.ordered_bmm` on the CPU: the plain product and its count, the
models' choice between it and the library (`model_bmm`), and the rules by
which DTensors multiply rank by rank (`_on_shards`), on a mesh of one
rank where every placement is legal and the result is the whole product.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import dispatch
from repro_torch.kernels import ordered_bmm as OB
from repro_torch.models import layers as L

R = Replicate()


@pytest.fixture
def mesh():
    from repro_torch.launch import mesh as M
    m = M.make_serve_mesh("data=1", device="cpu")
    yield m
    torch.distributed.destroy_process_group()


def _ab(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 3, 5, 4, generator=g),
            torch.randn(3, 4, 6, generator=g))


def test_plain_product_is_counted_and_model_bmm_follows_autograd():
    a, b = _ab()
    dispatch.reset_counts()
    assert torch.equal(OB.ordered_bmm(a, b), a @ b)
    assert dict(dispatch.PLAIN_CALLS) == {"ordered_bmm": 1}
    # training: the library's product, which carries the gradient
    a.requires_grad_(True)
    out = OB.model_bmm(a, b)
    out.sum().backward()
    assert torch.equal(out, a @ b) and a.grad is not None
    assert dict(dispatch.PLAIN_CALLS) == {"ordered_bmm": 1}
    with torch.no_grad():
        assert torch.equal(OB.model_bmm(a, b), a @ b)
    assert dict(dispatch.PLAIN_CALLS) == {"ordered_bmm": 2}
    # a shared b (K, P): every batch's rows against one matrix
    assert torch.equal(OB.ordered_bmm(a, b[0]), a @ b[0])
    x = torch.randn(4, 7, 16)
    with torch.no_grad():
        assert torch.equal(L.mean_square(x),
                           torch.mean(x * x, dim=-1, keepdim=True))


@pytest.mark.parametrize("pa,pb,want", [
    (Shard(0), R, (Shard(0), R)),            # a batch dim b broadcasts
    (Shard(1), R, (Shard(1), R)),            # b split alike
    (Shard(2), R, (Shard(2), R)),            # a's rows
    (Shard(3), R, (R, R)),                   # a's contraction: gathered
    (R, Shard(1), (R, R)),                   # b's contraction: gathered
    (R, Shard(2), (R, Shard(3))),            # b's columns
    (R, Shard(0), (R, Shard(1))),            # a split alike
    (Shard(2), Shard(2), (Shard(2), Shard(3))),
    (Partial(), R, (R, R)),                  # a partial sum summed first
])
def test_dtensors_multiply_rank_by_rank(mesh, pa, pb, want):
    """a's placement on the data dim, b's on the model dim: the result is
    the whole product, with the placements the rules give."""
    a, b = _ab(1)
    da = DTensor.from_local(a, mesh, [pa, R])
    db = DTensor.from_local(b, mesh, [R, pb])
    dispatch.reset_counts()
    with torch.no_grad():
        out = OB.model_bmm(da, db)
    assert isinstance(out, DTensor) and tuple(out.placements) == want
    assert torch.equal(out.full_tensor(), a @ b)
    assert dict(dispatch.PLAIN_CALLS) == {"ordered_bmm": 1}


def test_norm_of_a_dtensor_against_a_plain_column(mesh):
    x = torch.randn(2, 5, 8)
    dx = DTensor.from_local(x, mesh, [Shard(0), Shard(2)])
    out = OB.ordered_bmm(dx * dx, torch.ones(8, 1))
    assert tuple(out.placements) == (Shard(0), R)
    assert torch.equal(out.full_tensor(), (x * x) @ torch.ones(8, 1))
