"""The port's point sources against the JAX package's, on the CPU.

Both packages read the same numpy points (or generate them from the same
seed); every source's blocks, rows and gathers must be bitwise the JAX
source's, under any blocking. The pinned upload ring itself runs only on
the card (chip_smoke.py); here ``blocks`` yields plain CPU tensors.
"""
import numpy as np
import pytest
import torch

from repro.data import source as jsource
from repro_torch.data import pointsets
from repro_torch.data.source import (ArraySource, HostSource, MemmapSource,
                                     SyntheticSource, as_source, has_weights,
                                     is_source, stream_device,
                                     synthetic_source, weights_of)

N = 300


def _x(n=N, d=3, seed=0):
    return pointsets.gau(n, d=d, seed=seed)


def _pair(kind, tmp_path, x):
    """The same points as a port source and as a JAX source."""
    if kind == "array":
        return ArraySource(x, device="cpu"), jsource.ArraySource(x)
    if kind == "host":
        return HostSource(x), jsource.HostSource(x)
    if kind == "memmap":     # shards of 70 rows: blocks cross their edges
        port = MemmapSource.save_shards(x, tmp_path / "p", rows_per_shard=70)
        jax_ = jsource.MemmapSource.save_shards(x, tmp_path / "j",
                                                rows_per_shard=70)
        return port, jax_
    return (synthetic_source("unif", len(x), d=x.shape[1], seed=4),
            jsource.synthetic_source("unif", len(x), d=x.shape[1], seed=4))


@pytest.mark.parametrize("prefetch", [1, 2])
@pytest.mark.parametrize("rows", [1, 77, 256, N + 5])
@pytest.mark.parametrize("kind", ["array", "host", "memmap", "synthetic"])
def test_blocks_reproduce_the_jax_source(tmp_path, kind, rows, prefetch):
    x = _x()
    port, jax_ = _pair(kind, tmp_path, x)
    got = list(port.blocks(rows, prefetch=prefetch, device="cpu"))
    want = [np.asarray(b) for b in jax_.blocks(rows, prefetch=prefetch)]
    assert [b.shape[0] for b in got] == [b.shape[0] for b in want]
    assert all(b.dtype == torch.float32 and b.device.type == "cpu"
               for b in got)
    np.testing.assert_array_equal(torch.cat(got).numpy(),
                                  np.concatenate(want))
    if kind != "synthetic":
        np.testing.assert_array_equal(torch.cat(got).numpy(), x)
    # restartable
    again = torch.cat(list(port.blocks(rows, prefetch=prefetch, device="cpu")))
    assert torch.equal(again, torch.cat(got))


@pytest.mark.parametrize("kind", ["array", "host", "memmap", "synthetic"])
def test_row_take_and_materialize_match_jax(tmp_path, kind):
    x = _x()
    port, jax_ = _pair(kind, tmp_path, x)
    assert (port.n, port.d) == (jax_.n, jax_.d)
    for i in (0, 69, 70, N - 1):
        np.testing.assert_array_equal(port.row(i), np.asarray(jax_.row(i)))
    idx = [0, 1, 2, 69, 70, 71, 150, 5, N - 1]       # runs and a step back
    np.testing.assert_array_equal(port.take(idx), np.asarray(jax_.take(idx)))
    np.testing.assert_array_equal(port.materialize("cpu").numpy(),
                                  np.asarray(jax_.materialize()))
    with pytest.raises(IndexError):
        port.take([N])


@pytest.mark.parametrize("name", ["unif", "gau", "unb", "kddlike"])
def test_synthetic_families_match_jax(name):
    port = synthetic_source(name, 500, seed=7)
    jax_ = jsource.synthetic_source(name, 500, seed=7)
    for rows in (64, 500):
        np.testing.assert_array_equal(
            np.concatenate(list(port.host_blocks(rows))),
            np.concatenate(list(jax_.host_blocks(rows))))
    if name == "unif":       # bitwise the monolithic generator, any blocking
        np.testing.assert_array_equal(
            torch.cat(list(port.blocks(33, device="cpu"))).numpy(),
            pointsets.unif(500, seed=7))


def test_as_source_coercion_matches_jax():
    x = _x()
    assert isinstance(as_source(x), HostSource)
    assert isinstance(jsource.as_source(x), jsource.HostSource)
    t = torch.from_numpy(x)
    src = as_source(t)
    assert isinstance(src, ArraySource) and src.device == t.device
    assert src.materialize().data_ptr() == t.data_ptr()     # zero-copy
    h = HostSource(x)
    assert as_source(h) is h and is_source(h)
    assert not is_source(x) and not is_source(t)
    assert isinstance(synthetic_source("unif", 10), SyntheticSource)
    with pytest.raises(ValueError, match="unknown generator"):
        synthetic_source("nope", 10)


def test_memmap_many_shards_and_validation(tmp_path):
    x = _x(n=640, d=2)
    src = MemmapSource.save_shards(x, tmp_path, rows_per_shard=10)
    assert src.num_shards == 64
    np.testing.assert_array_equal(src._slice(95, 337), x[95:337])
    np.testing.assert_array_equal(src._slice(5, 5), np.zeros((0, 2)))
    np.save(tmp_path / "bad.npy", np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="expected"):
        MemmapSource([tmp_path / "shard_00000.npy", tmp_path / "bad.npy"])
    with pytest.raises(ValueError, match="at least one"):
        MemmapSource([])


def test_block_and_prefetch_validation():
    src = HostSource(_x())
    with pytest.raises(ValueError, match="block_rows"):
        list(src.blocks(0, device="cpu"))
    with pytest.raises(ValueError, match="prefetch"):
        src.blocks(8, prefetch=0, device="cpu")
    with pytest.raises(ValueError, match="prefetch"):
        stream_device(iter([]), prefetch=0, device="cpu")
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        HostSource(np.zeros(5, np.float32))


def test_unit_weights_and_weighted_sources_raise():
    src = HostSource(_x())
    assert not has_weights(src)
    np.testing.assert_array_equal(weights_of(src, 10, 4), np.ones(4))

    class Weighted(HostSource):
        has_weights = True

    with pytest.raises(NotImplementedError, match="weighted"):
        weights_of(Weighted(_x()), 0, 4)


def test_blocks_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for src in (HostSource(_x()), synthetic_source("unif", 50)):
        with pytest.raises(RuntimeError, match="CUDA"):
            src.blocks(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ArraySource(_x())
    # a tensor that is already placed keeps its device
    assert ArraySource(torch.from_numpy(_x())).device.type == "cpu"


# -- the per-process sources of a multi-process run ---------------------------

def _raises_alike(port_call, jax_call):
    """Both calls raise one exception type with one message."""
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(type(want.value)) as got:
        port_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("op", ["blocks", "host_blocks", "row", "take",
                                "materialize"])
def test_remote_shard_raises_on_every_data_access(op):
    from repro_torch.data import RemoteShard
    port, jax_ = RemoteShard(7, 3, process=2), jsource.RemoteShard(7, 3,
                                                                   process=2)
    assert (port.n, port.d, port.process, port.is_remote) == (7, 3, 2, True)
    arg = {"blocks": (4,), "host_blocks": (4,), "row": (0,), "take": ([0],),
           "materialize": ()}[op]
    _raises_alike(lambda: getattr(port, op)(*arg),
                  lambda: getattr(jax_, op)(*arg))
    _raises_alike(lambda: RemoteShard(-1, 3), lambda: jsource.RemoteShard(-1, 3))
    _raises_alike(lambda: RemoteShard(4, 0), lambda: jsource.RemoteShard(4, 0))


def test_for_process_validates_sizes_and_ids():
    from repro_torch.data import ProcessShardedSource, RemoteShard
    x = _x(n=30)
    for sizes, pid in (([31, 30], 0), ([10, 30], 0), ([30], 1), ([30], -1)):
        _raises_alike(
            lambda: ProcessShardedSource.for_process(HostSource(x), sizes, pid),
            lambda: jsource.ProcessShardedSource.for_process(
                jsource.HostSource(x), sizes, pid))
    src = ProcessShardedSource.for_process(HostSource(x), [5, 30, 7], 1)
    want = jsource.ProcessShardedSource.for_process(jsource.HostSource(x),
                                                    [5, 30, 7], 1)
    assert src.local_shard_ids == want.local_shard_ids == (1,)
    assert src.offsets.tolist() == want.offsets.tolist() == [0, 5, 35, 42]
    assert [getattr(s, "process", None) for s in src.shards] == [0, None, 2]
    # several shards a process: process 1 of 2 owns shards 2 and 3
    two = ProcessShardedSource.for_process(
        [HostSource(x[:20]), HostSource(x[20:])], [4, 4, 20, 10], 1)
    assert two.local_shard_ids == (2, 3)
    assert [getattr(s, "process", None) for s in two.shards] == [0, 0, None,
                                                                 None]
    with pytest.raises(ValueError, match="shards a process"):
        ProcessShardedSource.for_process([HostSource(x)] * 2, [30] * 3, 0)
    _raises_alike(
        lambda: ProcessShardedSource([RemoteShard(3, 3, process=1)]),
        lambda: jsource.ProcessShardedSource([jsource.RemoteShard(3, 3,
                                                                  process=1)]))


def test_one_process_take_reads_local_rows_and_raises_on_remote():
    from repro_torch.data import ProcessShardedSource
    x = _x(n=40)
    src = ProcessShardedSource.for_process(HostSource(x[:25]), [25, 15], 0)
    want = jsource.ProcessShardedSource.for_process(jsource.HostSource(x[:25]),
                                                    [25, 15], 0)
    idx = [24, 0, 7, 7]
    np.testing.assert_array_equal(src.take(idx), want.take(idx))
    np.testing.assert_array_equal(src.take(idx), x[idx])
    np.testing.assert_array_equal(src.row(3), x[3])
    _raises_alike(lambda: src.take([3, 30]), lambda: want.take([3, 30]))
    _raises_alike(lambda: src.row(40), lambda: want.row(40))
    # streaming and materializing reach the remote shard and raise
    _raises_alike(lambda: list(src.host_blocks(8)),
                  lambda: list(want.host_blocks(8)))
    with pytest.raises(RuntimeError, match="lives on process 1"):
        src.materialize("cpu")
