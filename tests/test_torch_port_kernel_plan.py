"""The launch plan of the port's tensor-core attention kernels, on the CPU.

``fairfedmed_tpu_torch/ops/attention.py:launch_plan`` is the arithmetic that
``csrc/attention_common.cuh:make_plan`` mirrors (the card's tests compare the
two through ``launch_info``).  Here, with no card and no JAX: at every shape
of ``chip_smoke.kernel_shapes()`` and at the edge lengths, the plan fits the
H100's shared memory (227 KB a block), packs no warp without rows and covers
every (batch*head) slice and every row exactly once, following the kernels'
documented mapping of blocks, warps and warpgroups onto rows.
"""

import collections

import pytest
import torch

import chip_smoke
from fairfedmed_tpu_torch.ops import attention as A

torch.set_num_threads(1)

SMEM_LIMIT = 232448  # bytes a block may use on the H100 (227 KB)
SMS = 132
EDGE_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 197, 256, 257)


def _coverage(kind, plan, n, length):
    """{(phase, slice, 16-row tile): times covered} by the plan's mapping.
    Packed: block b holds slices b*spb.. and warp w rows 16 (w % wps).. of
    slice b*spb + w // wps, in every phase.  Warpgroup forward: block b takes
    items b, b + blocks, ... (item = head * groups + group) and warpgroup w
    the rows of query tile group*tiles + w, while below L.  Warpgroup
    backward: block b is group b % groups of head b // groups; phase 1
    (keys) and phase 2 (queries) run in the same block (one group), in one
    block each (``phase_blocks``: group = phase), or in two launches (one
    per phase, groups of 4 tiles); warpgroup w takes tile group*tiles + w."""
    seen = collections.Counter()
    phases = ("keys", "queries") if kind == "bwd" else ("queries",)
    if plan["route"] == "packed":
        spb, wps = plan["slices_per_block"], plan["warps_per_slice"]
        assert plan["threads"] == 32 * spb * wps
        for b in range(plan["blocks"]):
            for w in range(spb * wps):
                s = b * spb + w // wps
                if s < n:
                    for phase in phases:
                        seen[(phase, s, w % wps)] += 1
        return seen
    tiles = plan["tiles_per_block"]
    assert plan["threads"] == 128 * tiles
    nt = -(-length // A.WG_ROWS)
    groups = -(-nt // tiles)

    def cover(phase, head, tile):
        if tile < nt:
            for r in range(4):  # the 16-row tiles of the warpgroup's 64 rows
                seen[(phase, head, 4 * tile + r)] += 1

    if kind == "fwd":
        for b in range(plan["blocks"]):
            for item in range(b, n * groups, plan["blocks"]):
                head, grp = divmod(item, groups)
                for w in range(tiles):
                    cover("queries", head, grp * tiles + w)
    elif plan["phase_blocks"]:
        assert plan["blocks"] == 2 * n and plan["launches"] == 1
        for b in range(plan["blocks"]):
            for w in range(tiles):
                cover(phases[b % 2], b // 2, w)
    else:
        assert plan["blocks"] == n * groups
        launches = [phases] if plan["launches"] == 1 else [("keys",), ("queries",)]
        for run in launches:
            for b in range(plan["blocks"]):
                head, grp = divmod(b, groups)
                for phase in run:
                    for w in range(tiles):
                        cover(phase, head, grp * tiles + w)
    return seen


def _check_plan(kind, n, length, dh):
    plan = A.launch_plan(kind, n, length, dh, sms=SMS)
    assert 0 < plan["smem_bytes"] <= SMEM_LIMIT, plan
    assert plan["launches"] == (2 if kind == "bwd" and length > 4 * A.WG_ROWS else 1)
    seen = _coverage(kind, plan, n, length)
    rows16 = -(-length // 16)
    phases = ("keys", "queries") if kind == "bwd" else ("queries",)
    if plan["route"] == "packed":
        assert length <= A.PACKED_MAX_LENGTH
        assert plan["rows_per_slice"] == 16 * rows16 and plan["warps_per_slice"] == rows16
        want = {(p, s, r) for p in phases for s in range(n) for r in range(rows16)}
        # every warp but those of a partial last block has rows
        assert plan["blocks"] == -(-n // plan["slices_per_block"])
    else:
        assert length > A.PACKED_MAX_LENGTH
        nt = -(-length // A.WG_ROWS)
        want = {(p, s, r) for p in phases for s in range(n) for r in range(4 * nt)}
    assert set(seen) == want and set(seen.values()) == {1}, (kind, n, length, dh)
    return plan


@pytest.mark.parametrize("shape", sorted(chip_smoke.kernel_shapes()))
def test_launch_plan_of_every_kernel_shape(shape):
    n, length, dh, _ = chip_smoke.kernel_shapes()[shape]
    fwd, bwd = _check_plan("fwd", n, length, dh), _check_plan("bwd", n, length, dh)
    if length <= A.PACKED_MAX_LENGTH:
        # short rows pack several slices a block, at most 4 warps, so several
        # blocks fit an SM
        assert fwd["route"] == bwd["route"] == "packed"
        assert fwd["threads"] <= 128 and 4 * bwd["smem_bytes"] <= SMEM_LIMIT
        if n >= 4 * SMS:  # a large call fills its blocks: 4 warps, or one slice of 3
            assert fwd["slices_per_block"] == max(1, 4 // fwd["warps_per_slice"])
    else:
        assert fwd["route"] == bwd["route"] == "wgmma"
        tiles = -(-length // A.WG_ROWS)
        if tiles <= 4:
            # one block reads a head's K and V once: no block per 128 rows
            assert fwd["blocks"] <= n and bwd["blocks"] == n * (2 if 2 * n <= SMS else 1)
        else:
            # EVA02's 577 rows: a block per head and group of 4 query tiles
            # (K and V through a ring of 4 slots), the backward in two launches
            assert fwd["blocks"] == bwd["blocks"] == n * -(-tiles // 4)
            assert (fwd["launches"], bwd["launches"]) == (1, 2)


@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_launch_plan_at_the_edge_lengths(length, dh):
    for n in (1, 3, 16, 4 * SMS + 3, 1600):
        for kind in ("fwd", "bwd"):
            _check_plan(kind, n, length, dh)


def test_launch_plan_packs_slices_and_sizes_shared_memory_to_the_rows():
    small = A.launch_plan("fwd", 1600, 16, 64)
    wide = A.launch_plan("fwd", 1600, 24, 64)
    assert (small["slices_per_block"], small["warps_per_slice"]) == (4, 1)
    assert (wide["slices_per_block"], wide["warps_per_slice"]) == (2, 2)
    # shared memory per slice follows L rounded up to 16, not a fixed ring
    per_slice = lambda p: p["smem_bytes"] // p["slices_per_block"]
    assert per_slice(wide) == 2 * per_slice(small) == 3 * 32 * (64 + 8) * 2
    bwd = A.launch_plan("bwd", 1600, 24, 64)
    assert bwd["smem_bytes"] == 2 * (4 * 32 * 72 * 2 + 2 * 32 * 4)
    # a small call spreads one slice a block over the SMs
    assert A.launch_plan("bwd", 32, 16, 64)["slices_per_block"] == 1
    # the forward's warpgroup blocks are persistent: at most one per SM at 4 tiles
    assert A.launch_plan("fwd", 1200, 197, 64)["blocks"] == SMS
    assert A.launch_plan("fwd", 32, 77, 64)["blocks"] == 32
    # the backward of few heads runs its two phases in two blocks per head
    few, many = A.launch_plan("bwd", 32, 77, 64), A.launch_plan("bwd", 384, 197, 64)
    assert (few["blocks"], few["phase_blocks"]) == (64, True)
    assert (many["blocks"], many["phase_blocks"]) == (384, False)


@pytest.mark.parametrize("args", [("fwd", 4, 16, 8), ("bwd", 4, 16, 128), ("sideways", 4, 16, 64),
                                  ("fwd", 0, 16, 64), ("bwd", 4, 0, 64)])
def test_launch_plan_rejects_what_the_tensor_cores_do_not_run(args):
    with pytest.raises(ValueError, match="no tensor-core plan"):
        A.launch_plan(*args)


@pytest.mark.parametrize("mode", sorted(A.WGMMA_CHECK_MODES))
def test_wgmma_check_reference_and_its_inputs(mode):
    gen = torch.Generator().manual_seed(mode)
    b = torch.randn(64, 32, generator=gen).to(torch.bfloat16)
    a = {0: torch.randn(64, 32, generator=gen), 1: torch.randn(64, 32, generator=gen),
         2: torch.randn(64, 64, generator=gen), 3: torch.randn(64, 32, generator=gen),
         4: torch.randn(64, 32, generator=gen)}[mode]
    if mode != 3:
        a = a.to(torch.bfloat16)
    ref = A.wgmma_check_reference(a, b, mode)
    bf = b.double()
    want = {0: lambda: bf.T, 1: lambda: bf[32:].T, 2: lambda: bf, 3: lambda: bf[32:],
            4: lambda: bf[16:32].T}[mode]()
    want = a.double() @ want
    assert ref.dtype == torch.float32 and ref.shape == want.shape
    assert torch.allclose(ref.double(), want, atol=1e-4)
    # the kernel runs on the card only: CPU tensors are refused, never computed
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.wgmma_check(a, b, mode)
    with pytest.raises(ValueError, match="wgmma check mode"):
        A.wgmma_check(a, b[:, :24].contiguous(), mode)
