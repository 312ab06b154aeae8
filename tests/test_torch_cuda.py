"""The hand kernels themselves on the card (yugabyte_db_tpu_torch/ops/
hand_scan.py): K1 and K2 (CUDA C++) and K3 (Triton), each against its
plain PyTorch version on the same CUDA tensors — counts, MIN and MAX
exact, f32 SUMs rtol 2e-4.  Every test here needs a GPU and skips
without one; the file imports nothing of JAX, so it runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from yugabyte_db_tpu_torch.ops import hand_scan as hs
# plain module name: the test directory is on sys.path (pytest's
# default import mode), and the card's machine may carry an unrelated
# top-level `tests` package
from torch_parity import (K3_CASES, assert_partials,  # noqa: F401
                                collect_consts, cuda_device, k3_lanes,
                                q6_inputs)

B = hs.BLOCK_ROWS


@pytest.mark.cuda
def test_cuda_q6_kernel_matches_plain(cuda_device):
    n = 64 * B
    qty, price, disc, ship = q6_inputs(n, seed=9)
    lanes = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
             for a in (qty, price, disc, ship)]
    valid = torch.ones(n, device=cuda_device)
    sc = torch.tensor([8766, 9131, 0.05, 0.07, 24.0], device=cuda_device)
    hs.reset_launches()
    got = hs.q6_scan_kernel(*lanes, valid, sc)
    assert hs.LAUNCHES["q6_scan"] == 1
    want = hs.q6_scan_plain(*lanes, valid, sc)
    assert_partials(got[1], want[1], "count")
    assert_partials(got[0], want[0], "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 6, 64, 4096])
def test_cuda_grouped_kernel_matches_plain(cuda_device, G):
    rng = np.random.default_rng(G)
    n = 16 * B
    gids, vals, mask = (torch.tensor(a, dtype=torch.float32,
                                     device=cuda_device)
                        for a in (rng.integers(-1, G + 1, n),
                                  rng.uniform(0, 10, n), rng.random(n) < .7))
    vals[7] = float("inf")
    got = hs.grouped_sum_kernel(gids, vals, mask, G)
    want = hs.grouped_sum_plain(gids, vals, mask, G)
    assert_partials(got, want, "sum")
    with pytest.raises(ValueError):
        hs.grouped_sum_kernel(gids, vals, mask, 4097)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_cuda_generic_kernel_matches_plain(cuda_device, name):
    where, aggs, group = K3_CASES[name]
    cols, nulls, valid = k3_lanes(8 * B, null_frac=0.1)
    order = tuple(sorted(cols))
    consts = collect_consts(where, aggs)
    G = int(np.prod([d for _, d, _ in group])) if group else None
    k3 = hs.GenericScan(where, aggs, group, G, order, order,
                               len(consts))
    dev = cuda_device
    call = (torch.tensor([float(c) for c in consts] or [0.0],
                         dtype=torch.float32, device=dev),
            [torch.from_numpy(cols[c]).to(dev) for c in order],
            [torch.from_numpy(nulls[c]).to(dev) for c in order],
            torch.from_numpy(valid).to(dev))
    got = k3(*call)
    assert k3.launches == 1
    want = k3.plain(*call)
    for (op, _), g, w in zip(list(aggs) + [("count", None)], got, want):
        assert_partials(g, w, op, f"{name} {op}")
