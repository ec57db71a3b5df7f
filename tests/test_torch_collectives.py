"""The port's explicit collectives (parallel/collectives.py) against the
JAX package's on the CPU: one launch of four gloo ranks runs suite
"collectives" of testing.grid_checks on the 2 x 2, 1 x 4 and 4 x 1
grids; each rank's local block must be the block reference device k
holds of the reference's result on
``slate_tpu.make_grid(p, q, devices=jax.devices()[:4])`` (twins of
tests/test_collectives.py), and every call is counted under the
reference's HLO kind."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import slate_tpu as jst
from slate_tpu.parallel import collectives as jcoll
from slate_tpu_torch.testing import grid_checks as gc
from slate_tpu_torch.testing import multiproc as mp

GRIDS = ["%dx%d" % g for g in gc.GRIDS]
X = gc.inputs("collectives")


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("coll"))
    box = {}

    def run():
        try:
            procs, outs = mp.launch(
                "slate_tpu_torch.testing.grid_checks", 4,
                extra_args=["collectives"], outdir=d, timeout=240)
            mp.assert_success(procs, outs)
            box["res"] = gc.load(outs)
        except BaseException as e:       # re-raised in the test thread
            box["exc"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, box


def _jgrid(name):
    p, q = (int(v) for v in name.split("x"))
    return jst.make_grid(p, q, devices=jax.devices()[:4])


def _put(g, a):
    return jax.device_put(jnp.asarray(a), g.matrix_sharding())


@pytest.fixture(scope="module")
def ref(launch):
    out = {}
    for name in GRIDS:
        g = _jgrid(name)
        a16 = _put(g, X["a16"])
        r = {"row_bcast": jcoll.row_bcast(g, a16),
             "col_bcast": jcoll.col_bcast(g, a16),
             "col_reduce": jcoll.col_reduce(g, a16),
             "row_reduce": jcoll.row_reduce(g, a16),
             "col_reduce_scatter": jcoll.col_reduce_scatter(g, a16),
             "ring_shift": jcoll.ring_shift(g, _put(g, X["r8"]), axis="q",
                                            shift=1),
             "summa": jcoll.summa_gemm(g, _put(g, X["s32a"]),
                                       _put(g, X["s32b"])),
             "summa16": jcoll.summa_gemm(g, _put(g, X["s16a"]),
                                         _put(g, X["s16b"])),
             "summa_rect": jcoll.summa_gemm(g, _put(g, X["reca"]),
                                            _put(g, X["recb"]))}
        for k in (7, 5):
            r["ragged%d" % k] = jcoll.summa_gemm(
                g, jnp.asarray(X["rga%d" % k]), jnp.asarray(X["rgb%d" % k]))
        out[name] = {k: np.asarray(v) for k, v in r.items()}
    return out


@pytest.fixture(scope="module")
def ranks(ref, launch):
    t, box = launch
    t.join()
    if "exc" in box:
        raise box["exc"]
    return box["res"]


#: the reference's out_specs: which mesh axis splits each dimension
SPECS = {"row_bcast": ("p", None), "col_bcast": (None, "q"),
         "col_reduce": (None, "q"), "row_reduce": ("p", None),
         "col_reduce_scatter": ("p", "q"), "ring_shift": ("p", "q"),
         "summa": ("p", "q"), "summa16": ("p", "q"),
         "summa_rect": ("p", "q")}


def _local(y, spec, name, k):
    """Reference device k's block of the global result y."""
    p, q = (int(v) for v in name.split("x"))
    pos = {"p": k // q, "q": k % q}
    size = {"p": p, "q": q}
    idx = []
    for d, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
        else:
            h = y.shape[d] // size[ax]
            idx.append(slice(pos[ax] * h, (pos[ax] + 1) * h))
    return y[tuple(idx)]


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("op", ["row_bcast", "col_bcast", "col_reduce",
                                "row_reduce", "col_reduce_scatter",
                                "ring_shift"])
def test_collective_matches_reference(ranks, ref, name, op):
    for k in range(4):
        got = ranks[k]["%s.%s" % (name, op)]["y"]
        np.testing.assert_allclose(got, _local(ref[name][op], SPECS[op],
                                               name, k), rtol=1e-12,
                                   atol=0)


@pytest.mark.parametrize("name", GRIDS)
def test_collectives_counted_by_kind(ranks, name):
    """Each call counts once under the reference's HLO kind: two
    gathers, two reductions, one reduce-scatter, one permute."""
    for k in range(4):
        c = ranks[k][name + ".kinds"]["counts"]
        assert c == {"all-gather": 2, "all-reduce": 2, "reduce-scatter": 1,
                     "collective-permute": 1, "all-to-all": 0}


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("op", ["summa", "summa16"])
def test_summa_gemm(ranks, ref, name, op):
    """The per-step panel SUMMA: each rank's block of A B, the reference's
    block to rounding, with two masked all-reduces a step."""
    a, b = (X["s32a"], X["s32b"]) if op == "summa" else \
        (X["s16a"], X["s16b"])
    for k in range(4):
        got = ranks[k]["%s.%s" % (name, op)]["y"]
        np.testing.assert_allclose(got, _local(a @ b, ("p", "q"), name, k),
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(got, _local(ref[name][op], ("p", "q"),
                                               name, k),
                                   rtol=1e-12, atol=1e-13)
    assert ranks[0][name + ".summa"]["counts"]["all-reduce"] == 2 * 4


@pytest.mark.parametrize("name", GRIDS)
def test_summa_gemm_panel_schedule_rectangular(ranks, ref, name):
    """Exact for rectangular shapes, and equal to the bulk all-gather
    variant."""
    want = X["reca"] @ X["recb"]
    for k in range(4):
        rec = ranks[k][name + ".summa_rect"]
        np.testing.assert_allclose(rec["y"], _local(want, ("p", "q"), name,
                                                    k), atol=1e-10)
        np.testing.assert_allclose(rec["y"], rec["bulk"], atol=1e-11)
        np.testing.assert_allclose(rec["y"], _local(
            ref[name]["summa_rect"], ("p", "q"), name, k), atol=1e-11)


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("k", [7, 5])
def test_summa_gemm_ragged_k(ranks, ref, name, k):
    """A k that is not a multiple of p*q is zero-padded (pad_k) first;
    the gathered product is A B on every rank."""
    want = X["rga%d" % k] @ X["rgb%d" % k]
    for r in range(4):
        got = ranks[r]["%s.ragged%d" % (name, k)]["y"]
        np.testing.assert_allclose(got, want, atol=1e-10)
        np.testing.assert_allclose(got, ref[name]["ragged%d" % k],
                                   atol=1e-11)
        assert np.array_equal(got, ranks[0]["%s.ragged%d" % (name, k)]["y"])


def test_pad_k_and_local_shapes_in_one_process():
    """pad_k pads k to a multiple of p*q with zeros; summa_gemm refuses
    local blocks whose k does not split into p*q panels."""
    import torch
    from slate_tpu_torch.parallel import collectives as coll
    from slate_tpu_torch.parallel.mesh import single_device_grid
    g = single_device_grid("cpu")
    a, b = torch.ones(4, 3), torch.ones(3, 2)
    pa, pb = coll.pad_k(g, a, b)
    assert pa is a and pb is b
    assert torch.equal(coll.summa_gemm(g, a, b), a @ b)
    assert torch.equal(coll.summa_gemm_allgather(g, a, b), a @ b)
    assert torch.equal(coll.tree_allreduce(g, a), a)
