"""Port parity: the multi-tenant multiplexer (``repro_torch.serving.
multiplex``) against the reference's (``tests/test_multiplex.py``).

Registration errors; under a fake clock the 3:1 row split of two
saturated lanes, strict priority and an idle lane banking no credit;
per-tenant metrics and flight tags; multiplexed rows equal each engine's
own and each workload's ``cross_check``; and the same traffic through the
JAX ``MultiTenantServer`` and the port's dispatches the lanes in the same
order and serves equal rows (float head within 1e-4).  The reference's
degradation-isolation test and the arbiter's backoff sleep are held in
``tests/test_torch_resilience.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import bnn_model as j_bnn
from repro.serving import MultiTenantServer as JMux
from repro.serving import PhoneBitEngine as JEngine
from repro_torch import workloads
from repro_torch.core.bnn_model import BConv, FloatDense, Pool
from repro_torch.serving import MultiTenantServer, PhoneBitEngine

HW = (16, 16)
FLOAT_ATOL = 1e-4


def _specs(mod, c: int):
    return [mod.BConv(3, c, kernel=3, stride=1, pad=1, first=True),
            mod.Pool(2, 2), mod.FloatDense(8 * 8 * c, 10)]


class _Port:
    BConv, Pool, FloatDense = BConv, Pool, FloatDense


@functools.lru_cache(maxsize=None)
def _jparams(seed: int, c: int):
    return j_bnn.init_params(jax.random.key(seed), _specs(j_bnn, c))


def _port_engine(seed: int, c: int) -> PhoneBitEngine:
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in _jparams(seed, c)]
    return PhoneBitEngine.from_trained(params, _specs(_Port, c), HW,
                                       matmul_mode="torch", device="cpu")


@pytest.fixture(scope="module")
def eng_a():
    return _port_engine(0, 16)


@pytest.fixture(scope="module")
def eng_b():
    return _port_engine(1, 32)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*HW, 3), dtype=np.uint8)
            for _ in range(n)]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _mux(cls=MultiTenantServer, **kw):
    clock = FakeClock()
    kw.setdefault("buckets", (1, 2))
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_wait_s", 0.0)
    return cls(clock=clock, **kw), clock


# --------------------------------------------------------------------------
# registration contract
# --------------------------------------------------------------------------

class TestRegistration:
    def test_duplicate_tenant_rejected(self, eng_a):
        mux, _ = _mux()
        mux.add_tenant("a", eng_a)
        with pytest.raises(ValueError, match="already registered"):
            mux.add_tenant("a", eng_a)

    def test_nonpositive_weight_rejected(self, eng_a):
        mux, _ = _mux()
        with pytest.raises(ValueError, match="weight"):
            mux.add_tenant("a", eng_a, weight=0.0)

    def test_unknown_tenant_submit_raises(self, eng_a):
        mux, _ = _mux()
        mux.add_tenant("a", eng_a)
        with pytest.raises(KeyError, match="unknown tenant"):
            mux.submit("nope", _images(1)[0])


# --------------------------------------------------------------------------
# weighted fairness + priority
# --------------------------------------------------------------------------

class TestFairness:
    def test_weighted_rows_split_3_to_1(self, eng_a, eng_b):
        """Both lanes saturated over an 8-step window: dispatched device
        rows split exactly by weight."""
        mux, _ = _mux()
        mux.add_tenant("a", eng_a, weight=3.0)
        mux.add_tenant("b", eng_b, weight=1.0)
        mux.server("a").compile_buckets()
        mux.server("b").compile_buckets()
        ra = [mux.submit("a", i) for i in _images(16)]
        rb = [mux.submit("b", i) for i in _images(16, seed=1)]
        for _ in range(8):
            mux.step(force=True)
        rows = {t: mux.server(t).dispatched_rows for t in ("a", "b")}
        assert rows == {"a": 12, "b": 4}
        mux.drain()
        assert all(r.outcome == "served" for r in ra + rb)
        fair = mux.metrics()["fairness"]
        assert fair["a"]["weight"] == 3.0
        assert fair["a"]["dispatched_rows"] == 16
        assert fair["b"]["dispatched_rows"] == 16

    def test_priority_class_preempts(self, eng_a, eng_b):
        """A backlogged higher-priority lane dispatches exclusively until
        its queue empties, whatever the weights."""
        mux, _ = _mux()
        mux.add_tenant("hi", eng_a, priority=1, weight=1.0)
        mux.add_tenant("lo", eng_b, priority=0, weight=100.0)
        rs_hi = [mux.submit("hi", i) for i in _images(4)]
        rs_lo = [mux.submit("lo", i) for i in _images(4, seed=1)]
        for _ in range(2):
            mux.step(force=True)
        assert mux.server("hi").dispatched_rows == 4
        assert mux.server("lo").dispatched_rows == 0
        mux.drain()
        assert all(r.outcome == "served" for r in rs_hi + rs_lo)
        assert mux.server("lo").dispatched_rows == 4

    def test_idle_lane_banks_no_credit(self, eng_a, eng_b):
        """A lane waking from idle starts at the arbiter's virtual clock."""
        mux, _ = _mux()
        mux.add_tenant("a", eng_a)
        mux.add_tenant("b", eng_b)
        for i in _images(6):
            mux.submit("a", i)
        for _ in range(3):
            mux.step(force=True)
        assert mux.lanes["a"].vtime == pytest.approx(6.0)
        assert mux.lanes["b"].vtime == 0.0      # idle, never charged
        mux.submit("b", _images(1)[0])
        assert mux.lanes["b"].vtime == pytest.approx(mux._v)
        assert mux.lanes["b"].vtime == pytest.approx(mux.lanes["a"].vtime)
        mux.drain()
        assert mux.queue_depth == 0


# --------------------------------------------------------------------------
# per-tenant observability
# --------------------------------------------------------------------------

def test_per_tenant_metrics_and_flight_tags(eng_a, eng_b):
    mux, _ = _mux()
    mux.add_tenant("a", eng_a)
    mux.add_tenant("b", eng_b)
    rs = [mux.submit("a", i) for i in _images(2)]
    rs += [mux.submit("b", i) for i in _images(2, seed=1)]
    mux.drain()
    assert all(r.outcome == "served" for r in rs)
    m = mux.metrics()
    assert m["tenants"]["a"]["tenant"] == "a"
    assert m["tenants"]["b"]["tenant"] == "b"
    assert m["queue_depth"] == 0
    for t in ("a", "b"):
        recs = mux.server(t).flight.dump()
        assert recs and all(r["tenant"] == t for r in recs)


def test_housekeeping_step_dispatches_nothing(eng_a):
    """``step(dispatch=False)`` scatters the in-flight batch and sheds,
    but assembles nothing."""
    mux, clock = _mux()
    srv = mux.add_tenant("a", eng_a)
    late = srv.submit(_images(1)[0], deadline_s=1.0)
    ok = srv.submit(_images(1)[0])
    clock.t = 2.0
    assert srv.step(dispatch=False) == []
    assert late.outcome == "shed" and srv.dispatched_rows == 0
    srv.step(force=True)
    done = srv.step(dispatch=False)
    assert done == [ok] and ok.outcome == "served"
    assert srv.dispatched_rows == 1


# --------------------------------------------------------------------------
# numerics: multiplexing never changes results
# --------------------------------------------------------------------------

def test_multitenant_workloads_match_cross_check_oracle():
    """Two tiny workloads behind one multiplexer: every served row equals
    the workload's own ``cross_check`` on the same preprocessed input."""
    mux, _ = _mux(buckets=(1,), max_batch=1)
    wls = {t: workloads.get(name, variant="tiny", device="cpu",
                            matmul_mode="cuda_direct_pool")
           for t, name in (("alex", "alexnet_imagenet"),
                           ("vgg", "vgg16_imagenet"))}
    for t, wl in wls.items():
        mux.add_workload(t, wl)
    rng = np.random.default_rng(0)
    # Off-network sizes: the lane's preprocess hook normalizes them.
    imgs = {t: [rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
                for _ in range(2)] for t in wls}
    rs = {t: [mux.submit(t, i) for i in imgs[t]] for t in wls}
    mux.drain()
    for t, wl in wls.items():
        assert all(r.outcome == "served" for r in rs[t])
        for r, img in zip(rs[t], imgs[t]):
            x = torch.stack([wl.preprocess_hook(img)])
            want = wl.engine.cross_check(x).numpy()[0]
            np.testing.assert_array_equal(r.result, want)


def test_multiplexed_results_equal_each_engines(eng_a, eng_b):
    mux, _ = _mux(buckets=(1,), max_batch=1)
    mux.add_tenant("a", eng_a)
    mux.add_tenant("b", eng_b)
    imgs_a, imgs_b = _images(3), _images(3, seed=1)
    ra = [mux.submit("a", i) for i in imgs_a]
    rb = [mux.submit("b", i) for i in imgs_b]
    mux.drain()
    assert all(r.outcome == "served" for r in ra + rb)
    for eng, reqs, imgs in ((eng_a, ra, imgs_a), (eng_b, rb, imgs_b)):
        for r, img in zip(reqs, imgs):
            want = eng.compile(1)(torch.from_numpy(img[None])).numpy()[0]
            np.testing.assert_array_equal(r.result, want)


def test_same_lane_order_and_rows_as_reference():
    """One trace of mixed traffic (weights 3:1, a later higher-priority
    tenant, an idle lane waking) through the JAX multiplexer and the
    port's: after every tick each lane has dispatched the same rows, and
    every request's row agrees."""
    specs = {"a": (0, 16), "b": (1, 32), "c": (2, 16)}
    port, _ = _mux()
    ref, _ = _mux(JMux)
    for t, (seed, c) in specs.items():
        kw = dict(weight=3.0 if t == "a" else 1.0,
                  priority=1 if t == "c" else 0)
        port.add_tenant(t, _port_engine(seed, c), **kw)
        ref.add_tenant(t, JEngine.from_trained(_jparams(seed, c),
                                               _specs(j_bnn, c), HW), **kw)
    imgs = {t: _images(7, seed=10 + i) for i, t in enumerate(specs)}
    schedule = ([("a", i) for i in range(7)] + [("b", i) for i in range(5)],
                [], [("c", i) for i in range(3)], [], [("b", 5), ("b", 6)])
    reqs = {"port": [], "ref": []}
    order = {"port": [], "ref": []}
    for arrivals in schedule + ([],) * 12:
        for name, mux in (("port", port), ("ref", ref)):
            reqs[name] += [mux.submit(t, imgs[t][i]) for t, i in arrivals]
            mux.step(force=True)
            order[name].append(tuple(mux.server(t).dispatched_rows
                                     for t in specs))
    port.drain()
    ref.drain()
    assert order["port"] == order["ref"]
    assert order["port"][-1] == (7, 7, 3)       # every row dispatched
    for got, want in zip(reqs["port"], reqs["ref"]):
        assert got.outcome == want.outcome == "served"
        np.testing.assert_allclose(got.result, np.asarray(want.result),
                                   rtol=0, atol=FLOAT_ATOL)
        np.testing.assert_array_equal(np.argmax(got.result),
                                      np.argmax(np.asarray(want.result)))
