"""The port's kernel modules against the JAX package's ops, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. On the
CPU the port runs its plain versions; the JAX side runs its Pallas kernels
in interpret mode and its jnp oracle. Exact-arithmetic inputs (small
integer coordinates: every f32 sum exact) must match bitwise, tie-breaks
included; general float inputs match within tests/test_kernels.py's
tolerances, with indices compared where the winner is unique by 1e-5.
The CUDA kernels themselves run only on the card (chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gonzalez as jgonzalez
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core.gonzalez import _gonzalez_device
from repro_torch.kernels import _build, engine
from repro_torch.kernels.assign import (WIDE_MAX_D, WIDE_MAX_KD, assign_nearest_cuda,
                                        assign_plan)
from repro_torch.kernels._build import SMEM_LIMIT, SMEM_PER_SM
from repro_torch.kernels.fused_argfar import (MAX_CTAS_PER_SM, fused_min_argmax_cuda,
                                              gon_plan)
from repro_torch.kernels.fused_stream import (ROUTE_SMALL, ROUTE_TILED, ROUTE_WIDE,
                                              SMALL_MAX_D, TILED_MIN_KD, argmin_plan,
                                              filter_plan)
from repro_torch.kernels.pairwise import (LARGE_MIN_TILES, MMA_SMEM, PERSIST_MIN_D,
                                          pairwise_plan)

_NEG = np.float32(-3.4e38)


def _points(rng, shape, tier):
    if tier == "exact":
        return np.floor(rng.random(shape) * 40).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _gon_inputs(m, per, d, tier, seed=0):
    rng = np.random.default_rng(seed)
    x = _points(rng, (m, per, d), tier)
    c = _points(rng, (m, d), tier)
    md = (np.floor(rng.uniform(0, 2000, (m, per))) if tier == "exact"
          else rng.uniform(0.5, 20, (m, per))).astype(np.float32)
    md[:, ::5] = _NEG          # masked / padded rows
    md[-1, :] = _NEG           # a machine with no valid row at all
    return x, c, md


@pytest.mark.parametrize("jimpl", ["ref", "pallas"])
@pytest.mark.parametrize("tier,d", [("exact", 5), ("float", 2), ("float", 7),
                                    ("exact", 38)])
def test_gon_step_matches_jax_per_machine(jimpl, tier, d):
    m, per = 4, 300
    x, c, md = _gon_inputs(m, per, d, tier)
    st = interop.state_from_jax({"x": x, "c": c, "md": md}, "cpu")
    # the path's form: the next center goes to slot 1 of (m, k, d) outputs
    centers = torch.full((m, 3, d), -1.0)
    indices = torch.full((m, 3), -1, dtype=torch.int32)
    new_md, far_v, far_i = engine.fused_min_argmax(
        st["x"], st["c"], st["md"], impl="ref", centers=centers,
        indices=indices, slot=1)
    assert new_md.data_ptr() == st["md"].data_ptr()     # in place
    assert far_i.dtype == torch.int32 and far_v.shape == (m,)
    rows = torch.arange(m)
    assert torch.equal(indices[:, 1], far_i)
    assert torch.equal(far_i.long(), torch.argmax(new_md, dim=1))
    assert torch.equal(centers[:, 1], st["x"][rows, far_i.long()])
    assert (centers[:, [0, 2]] == -1).all() and (indices[:, [0, 2]] == -1).all()
    for b in range(m):
        jm, jv, ji = jops.fused_min_argmax(x[b], c[b], md[b], impl=jimpl,
                                           bn=64)
        jm = np.asarray(jm)
        # at d = 2 the direct form rounds the same in torch and jnp; the
        # Pallas kernel, compiled, may contract it into an FMA
        if tier == "exact" or (d == 2 and jimpl == "ref"):
            np.testing.assert_array_equal(new_md[b].numpy(), jm)
            assert int(far_i[b]) == int(ji)
            assert far_v[b].numpy() == np.float32(jv)
        else:
            np.testing.assert_allclose(new_md[b].numpy(), jm, rtol=1e-5)
            np.testing.assert_allclose(float(far_v[b]), float(jv), rtol=1e-5)
            top = np.sort(jm)[-2:]
            if top[1] - top[0] > 1e-5 * abs(top[1]):
                assert int(far_i[b]) == int(ji)
        # masked rows stay at the sentinel and win only an all-masked machine
        assert (new_md[b, ::5].numpy() == _NEG).all()
        if b < m - 1:
            assert int(far_i[b]) % 5 != 0
        else:
            assert int(far_i[b]) == 0 and far_v[b].numpy() == _NEG


@pytest.mark.parametrize("jimpl", ["ref", "pallas"])
@pytest.mark.parametrize("tier,n,k,d", [("exact", 500, 37, 10),
                                        ("exact", 200, 1, 2),
                                        ("float", 500, 13, 2),
                                        ("float", 300, 37, 6)])
def test_assign_nearest_matches_jax(jimpl, tier, n, k, d):
    rng = np.random.default_rng(3)
    x = _points(rng, (n, d), tier)
    c = _points(rng, (k, d), tier)
    st = interop.state_from_jax({"x": x, "c": c}, "cpu")
    idx, d2 = engine.assign_nearest(st["x"], st["c"], impl="ref")
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    jidx, jd2 = jops.assign_nearest(x, c, impl=jimpl, bn=64, bm=8)
    jidx, jd2 = np.asarray(jidx), np.asarray(jd2)
    if tier == "exact":
        np.testing.assert_array_equal(idx.numpy(), jidx)
        np.testing.assert_array_equal(d2.numpy(), jd2)
    else:
        np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-4, atol=1e-4)
        part = np.partition(np.asarray(jref.pairwise_dist2(x, c)), 1, axis=1)
        unique = part[:, 1] - part[:, 0] > 1e-5
        np.testing.assert_array_equal(idx.numpy()[unique], jidx[unique])


@pytest.mark.parametrize("tier,masked", [("exact", True), ("float", False)])
def test_gon_slots_match_jax_gonzalez_device(tier, masked):
    # the batched loop (step i reads slot i, writes slot i + 1) against the
    # JAX package's GON on each machine
    m, per, d, k = 3, 200, 4, 7
    rng = np.random.default_rng(7)
    x = _points(rng, (m, per, d), tier)
    mask = rng.random((m, per)) < 0.7 if masked else None
    got = _gonzalez_device(torch.from_numpy(x), k, impl="ref",
                           mask=None if mask is None else torch.from_numpy(mask))
    assert got.centers.shape == (m, k, d) and got.indices.dtype == torch.int32
    for b in range(m):
        want = jgonzalez(jnp.asarray(x[b]), k, impl="ref",
                         mask=None if mask is None else jnp.asarray(mask[b]))
        np.testing.assert_array_equal(got.indices[b].numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.centers[b].numpy(), np.asarray(want.centers))
        if tier == "exact":
            assert got.radius2[b].numpy() == np.asarray(want.radius2)
        else:
            np.testing.assert_allclose(float(got.radius2[b]),
                                       float(want.radius2), rtol=1e-6)


@pytest.mark.parametrize("d", [1, 2, 3, 38, 65, 128, 130, 202])
def test_launch_plans_fit_shared_memory(d):
    # the wrappers' launch plans, for the H100's 132 SMs
    sms = 132
    for m in (1, 25, 50, 100, 129, 300, 1000):
        for per in (1, 3_000, 20_000, 573_580):
            plan = gon_plan(m, per, d, sms)
            assert plan.smem <= SMEM_LIMIT
            assert plan.tile_rows * d * 4 <= 36 * 1024 or plan.tile_rows == 1
            assert plan.ntiles * plan.tile_rows >= per
            assert 1 <= plan.grid <= min(m * plan.ntiles, MAX_CTAS_PER_SM * sms)
            # every CTA holds one machine's tiles where the CTAs outnumber m
            if plan.grid >= m:
                assert plan.grid % m == 0
        a = argmin_plan(573_580, m, d, sms)
        assert a.tc >= 1, "d <= 202 takes the tiled kernel"
        assert a.smem + 4 * 128 * 8 <= SMEM_LIMIT
        assert 16 * a.tc * a.ctiles >= m and 16 * a.tc <= 128
        assert a.grid_x * a.ctiles <= 2 * sms + a.ctiles
        if d <= 130:            # the path's widths keep the widest center tiles
            assert a.ctiles == -(-m // 128)
    assert argmin_plan(100, 5, 203, sms).tc == 0        # the wide kernel
    assert argmin_plan(100, 5, 1000, sms).tc == 0
    # csrc/pairwise.cu: shared memory, every output tile covered (m past the
    # previous grid's 65,535 · 64 too), f16 slabs a multiple of 16 deep, and
    # the routes on the measured boundaries
    for n, m in ((1, 1), (26, 26), (101, 101), (384, 384), (512, 512), (768, 768),
                 (65_536, 1_024), (2, 65_535 * 64 + 3), (100_000, 60), (8_192, 1)):
        for half in (False, True):
            p = pairwise_plan(n, m, d, half, sms)
            assert p.smem <= SMEM_LIMIT
            rows, cols = 16 * p.tr, 16 * p.tc
            assert p.tiles_m == -(-m // cols) and p.tiles == -(-n // rows) * p.tiles_m
            assert 1 <= p.grid <= p.tiles
            large = -(-n // 128) * -(-m // 128) >= LARGE_MIN_TILES
            if p.route == "mma":
                assert half and large and (rows, cols) == (128, 128)
                assert p.ks % 16 == 0 and p.smem == MMA_SMEM
                assert p.grid == (min(p.tiles, 2 * sms) if PERSIST_MIN_D <= d <= p.ks
                                  else p.tiles)
                continue
            assert p.route == ("large" if large else "small")
            assert (rows, cols) == {"large": (128, 128), "small": (16, 16)}[p.route]
            slabs = -(-d // p.ks)
            assert 1 <= p.ks <= d and slabs * p.ks - d < slabs
            assert p.ks <= 48 or p.route != "large"
            assert p.smem == 4 * (2 * p.ks * (rows + cols + 8) + rows + cols)
            if p.ks == d >= PERSIST_MIN_D:      # persistent: two CTAs a SM at most
                assert p.grid <= (2 if p.route == "large" else 3) * sms
            else:
                assert p.grid == p.tiles
    assert pairwise_plan(101, 101, 38, False, sms).route == "small"
    # the measured boundary: 16 × 16 tiles at 256² (4 large tiles), the large
    # route at 512² (16), at d = 2 and 38 alike
    for d2 in (2, 38):
        assert pairwise_plan(256, 256, d2, False, sms).route == "small"
        assert pairwise_plan(512, 512, d2, False, sms).route == "large"
    assert pairwise_plan(65_536, 1_024, 38, True, sms).route == "mma"


@pytest.mark.parametrize("d", [1, 2, 3, 8, 12, 38, 64, 65, 200, 203, 1000])
def test_assign_plan_fits_shared_memory_and_covers(d):
    # csrc/assign.cu's shared-memory layout, recomputed here, for 132 SMs
    sms = 132
    for k in (1, 25, 125, 300, 2000):
        for sums in (False, True):
            bins = 4 * k if sums else 0
            for n, m in ((1, 1), (100, 1), (573_580, 1), (20_000, 50)):
                p = assign_plan(n, k, d, sms, m, sums)
                assert p.smem <= SMEM_LIMIT and p.grid_x >= 1
                assert p.bins == sums
                if p.tc == 0:                   # the wide kernel
                    assert p.grid_x * 128 >= n
                    assert 1 <= p.chunk <= k and p.chunk * (d + 1) <= 8192
                    assert p.smem == 4 * p.chunk * (d + 1) + bins
                    continue
                tile, rows = 16 * p.tc, 128 * p.sub
                assert 1 <= p.tc <= 8 and 1 <= p.sub <= 8
                assert rows * d * 4 <= 16 * 1024 or p.sub == 1
                nchunks = -(-k // (p.chunk * tile))
                assert p.chunk * tile * nchunks >= k          # every center
                assert p.grid_x <= max(1, 2 * sms // m)       # grid-strides rows
                carried = 8 * rows if nchunks > 1 else 0
                assert p.smem == 4 * (2 * d * (rows + 4) + rows + d * (p.chunk * tile + 1)
                                      + p.chunk * tile) + carried + bins
                if d <= 130 and k <= 128:       # the path's shapes: all resident
                    assert nchunks == 1 and p.chunk == 1
            # the wide kernel where it measured faster, or where not even a
            # 16-center tile fits beside two 128-row stages
            fits = (4 * (2 * d * 132 + 128 + d + 16 * (d + 1)) + bins
                    + (8 * 128 if k > 16 else 0)) <= SMEM_LIMIT
            small = d <= WIDE_MAX_D or k * d < WIDE_MAX_KD
            assert (assign_plan(573_580, k, d, sms, 1, sums).tc == 0) == (small or not fits)
    assert assign_plan(20_000, 2000, 38, sms).chunk < -(-2000 // 128)    # chunks
    _check_filter_plan(d, sms)


def _check_filter_plan(d, sms):
    # csrc/fused_filter.cu's launch shapes, recomputed here: shared memory,
    # tiles as whole stages of one CTA, every tile covered, the routing
    for k in (1, 25, 125, 300, 2000):
        for n in (1, 100, 256, 257, 573_580, 1_864_135):
            f = filter_plan(n, k, d, sms)
            tiles = -(-n // 256)
            assert 1 <= f.grid_x
            # the small-d and wide kernels launch without the opt-in past
            # 48 KB: dynamic plus their static top-rank buffers stay below
            if f.route == ROUTE_SMALL:          # 4 tiles a CTA, a row each a thread
                per = f.tc // 4 + 1             # float4 a center: D values, the norm
                assert f.tc in (2, 4, 8) and d <= f.tc < 4 * per
                assert 1 <= f.chunk <= k and f.smem == 16 * per * f.chunk
                assert f.smem + 4 * 4 * 256 <= 48 * 1024
                assert f.grid_x == -(-tiles // 4)
                continue
            if f.route == ROUTE_WIDE:           # a tile a CTA
                assert f.grid_x == tiles and f.tc == f.sub == 0
                assert 1 <= f.chunk <= k and f.smem == 4 * f.chunk * (d + 1)
                assert f.smem + 4 * 256 <= 48 * 1024
                continue
            assert f.route == ROUTE_TILED and f.smem <= SMEM_LIMIT
            rows, tile = 128 * f.sub, 16 * f.tc
            assert f.sub in (1, 2) and 256 % rows == 0    # a tile: 1 or 2 stages
            assert 1 <= f.tc <= 8 and f.grid_x <= min(tiles, 2 * sms)
            nchunks = -(-k // (f.chunk * tile))
            assert f.chunk * tile * nchunks >= k          # every center
            carried = 4 * rows if nchunks > 1 else 0
            assert f.smem == 4 * (2 * d * (rows + 4) + rows + 256 + d * (f.chunk * tile + 1)
                                  + f.chunk * tile) + carried
            if d <= 38 and k <= 125:    # the path's shapes: 256-row stages, 2 CTAs a SM
                assert f.sub == 2 and nchunks == 1 and 2 * (f.smem + 1024) <= SMEM_PER_SM
        # the routing the plan's thresholds record, the tiled kernel only
        # where a 16-center tile fits beside two 128-row stages
        fits = 4 * (2 * d * 132 + 128 + 256 + d + 16 * (d + 1)) + 4 * 128 <= SMEM_LIMIT
        want = (ROUTE_SMALL if d <= SMALL_MAX_D else
                ROUTE_TILED if k * d >= TILED_MIN_KD and fits else ROUTE_WIDE)
        assert filter_plan(573_580, k, d, sms).route == want


def test_dispatch_auto_ref_kernel_on_cpu():
    x, c, md = _gon_inputs(2, 40, 3, "exact")
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    before = (fused_min_argmax_cuda.launches, assign_nearest_cuda.launches)
    assert engine.gon_workspace(2, xt) is None          # the plain route's
    a = engine.fused_min_argmax(xt, ct, torch.from_numpy(md.copy()))
    b = engine.fused_min_argmax(xt, ct, torch.from_numpy(md.copy()),
                                impl="ref")
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    ia, da = engine.assign_nearest(xt[0], ct)
    ib, db = engine.assign_nearest(xt[0], ct, impl="ref")
    assert torch.equal(ia, ib) and torch.equal(da, db)
    # the plain route never counts as a kernel launch
    assert (fused_min_argmax_cuda.launches,
            assign_nearest_cuda.launches) == before
    # the kernel route takes no CPU tensor, and no impl is guessed
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.fused_min_argmax(xt, ct, torch.from_numpy(md.copy()),
                                impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.assign_nearest(xt[0], ct, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        engine.assign_nearest(xt[0], ct, impl="pallas")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()
    # each source's library name follows its content
    names = {_build.library_path(s).name for s in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)


def test_interop_maps_dtypes_exactly():
    arrays = {"points": np.ones((3, 2), np.float32),
              "indices": np.arange(3, dtype=np.int32),
              "valid": np.array([True, False, True])}
    st = interop.state_from_jax(arrays, "cpu")
    assert [st[k].dtype for k in arrays] == [torch.float32, torch.int32,
                                             torch.bool]
    for k in arrays:
        np.testing.assert_array_equal(st[k].numpy(), arrays[k])
    with pytest.raises(TypeError, match="float64"):
        interop.state_from_jax({"x": np.ones(2)}, "cpu")
