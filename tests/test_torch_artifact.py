"""Port parity: executable artifacts (``repro_torch.serving.artifact``)
against the reference's contract (``tests/test_artifact.py``).

* A round trip: buckets exported from one port engine and loaded into a
  fresh one serve what the exporter serves and what the JAX ``xla``
  engine serves on the same params and inputs (float head within 1e-4);
  every mode's frozen executor (regions and their tiles included) comes
  back equal.
* The compatibility protocol: a mismatch on any ``COMPAT_FIELDS`` entry
  is a per-bucket ``artifact.miss`` and the bucket compiles live; a
  fingerprint mismatch, a loaded subset of buckets, a workload that wants
  the head.
* Integrity: a corrupted, unparsable or missing plan, and a plan that
  names a node or backend the graph lacks, raise ``ArtifactError``.
* The autotune table rides along, and a load under ``"auto"`` records no
  tuner outcome at all.
* The server's ``artifact=`` kwarg, and a fresh subprocess that imports
  ``repro_torch`` alone and serves from the artifact with no tuner miss
  and a flat ``build_count``.

On the CPU nothing is captured (``capture=None`` is off there); the
captures a load makes on the card are held in ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import functools
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnn_model as j_bnn
from repro.serving import PhoneBitEngine as JEngine
from repro_torch import workloads as t_workloads
from repro_torch.core.bnn_model import BConv, FloatDense, Pool
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime import autotune
from repro_torch.serving import (ArtifactError, InferenceServer,
                                 PhoneBitEngine, export_artifact,
                                 load_artifact, read_meta)
from repro_torch.serving.artifact import (ARTIFACT_SCHEMA, COMPAT_FIELDS,
                                          load_autotune_table)

REPO = pathlib.Path(__file__).resolve().parent.parent
HW = (16, 16)
T_SPEC = [BConv(3, 16, kernel=3, stride=1, pad=1, first=True),
          Pool(2, 2), FloatDense(8 * 8 * 16, 10)]
J_SPEC = [j_bnn.BConv(3, 16, kernel=3, stride=1, pad=1, first=True),
          j_bnn.Pool(2, 2), j_bnn.FloatDense(8 * 8 * 16, 10)]
# The float head's tolerance (tests/harness.py): packed words are exact.
FLOAT_ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jparams():
    return j_bnn.init_params(jax.random.key(0), J_SPEC)


def _params() -> list[dict]:
    return [{k: np.asarray(v) for k, v in p.items()} for p in _jparams()]


def _engine(mode: str = "torch", spec=None) -> PhoneBitEngine:
    return PhoneBitEngine.from_trained(_params(), spec or T_SPEC, HW,
                                       matmul_mode=mode, device="cpu")


def _imgs(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8)


def _rewrite_meta(art: pathlib.Path, **fields) -> None:
    path = art / "meta.json"
    meta = json.loads(path.read_text())
    meta.update(fields)
    path.write_text(json.dumps(meta))


# --------------------------------------------------------------------------
# round trip
# --------------------------------------------------------------------------

class TestRoundtrip:
    def test_equal_to_exporter_and_reference(self, tmp_path):
        src = _engine()
        meta = export_artifact(src, tmp_path / "art", buckets=(1, 2))
        assert meta["schema"] == ARTIFACT_SCHEMA == read_meta(
            tmp_path / "art")["schema"]
        assert sorted(meta["buckets"]) == ["1", "2"]
        assert meta["device_kind"] == "cpu" and meta["data_parallel"] == 1
        assert "jax" not in meta and meta["torch"] == torch.__version__

        dst = _engine()
        with obs_metrics.use_registry() as reg:
            rep = load_artifact(dst, tmp_path / "art")
        assert rep["loaded"] == [1, 2] and not rep["missed"]
        assert reg.counter("artifact.hit").value == 2
        assert [e["outcome"] for e in reg.events("artifact")] == \
            ["hit", "hit"]
        assert dst.capture_count == 0          # nothing captured on the CPU

        x = _imgs(2)
        builds = dst.build_count
        got = dst.compile(2)(torch.from_numpy(x))
        assert dst.build_count == builds       # the loaded bucket served
        assert torch.equal(got, src.compile(2)(torch.from_numpy(x)))
        want = np.asarray(JEngine.from_trained(_jparams(), J_SPEC, HW)
                          .compile(2)(jnp.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FLOAT_ATOL)
        dst.cross_check(torch.from_numpy(x))

    @pytest.mark.parametrize("mode", ["torch", "torch_pm1",
                                      "cuda_direct_pool", "cuda_chain",
                                      "auto"])
    def test_every_mode_round_trips(self, tmp_path, mode, monkeypatch):
        """The tiny AlexNet workload: the loaded bucket's frozen executor
        (backends, tiles, regions) equals the exporter's, and serves the
        same rows."""
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "0")
        src = t_workloads.get("alexnet_imagenet", variant="tiny",
                              device="cpu", matmul_mode=mode)
        src.engine.export_artifact(tmp_path / "art", buckets=(2,),
                                   workload=src.name)
        dst = t_workloads.get("alexnet_imagenet", variant="tiny",
                              device="cpu", matmul_mode=mode)
        rep = dst.engine.load_artifact(tmp_path / "art")
        assert rep == {"loaded": [2], "missed": {}, "workload": src.name,
                       "autotune_entries": rep["autotune_entries"]}
        a = src.engine.engine.compile(2)
        b = dst.engine.engine.compile(2)
        assert a.backend_report() == b.backend_report()
        assert [c.node_ids for c in a.regions] == \
            [c.node_ids for c in b.regions]
        if mode == "cuda_chain":
            assert len(b.regions) == 1
        x = torch.from_numpy(_imgs(2))
        assert torch.equal(dst.engine(x), src.engine(x))
        dst.engine.cross_check(x)

    def test_server_artifact_kwarg(self, tmp_path):
        export_artifact(_engine(), tmp_path / "art", buckets=(1, 2))
        eng = _engine()
        server = InferenceServer(eng, artifact=str(tmp_path / "art"),
                                 buckets=(1, 2), max_batch=2)
        assert server.artifact_report["loaded"] == [1, 2]
        builds = eng.build_count
        rs = [server.submit(i) for i in _imgs(3)]
        server.drain()
        assert [r.outcome for r in rs] == ["served"] * 3
        assert eng.build_count == builds

    def test_read_meta_missing_dir(self, tmp_path):
        with pytest.raises(ArtifactError, match="not an artifact"):
            read_meta(tmp_path / "nope")


# --------------------------------------------------------------------------
# compatibility: every COMPAT field mismatch is a per-bucket miss
# --------------------------------------------------------------------------

class TestCompatFallback:
    @pytest.mark.parametrize("field", COMPAT_FIELDS)
    def test_meta_mismatch_falls_back_per_bucket(self, tmp_path, field):
        art = tmp_path / "art"
        meta = export_artifact(_engine(), art, buckets=(1, 2))
        wrong = {"donate_input": not meta["donate_input"],
                 "data_parallel": meta["data_parallel"] + 1}
        _rewrite_meta(art, **{field: wrong.get(field, "other")})

        dst = _engine()
        with obs_metrics.use_registry() as reg:
            rep = load_artifact(dst, art)
        assert rep["loaded"] == []
        assert sorted(rep["missed"]) == [1, 2]
        assert all(any(reason.startswith(field + ":") for reason in reasons)
                   for reasons in rep["missed"].values())
        evs = reg.events("artifact")
        assert [e["outcome"] for e in evs] == ["miss", "miss"]
        assert {e["bucket"] for e in evs} == {1, 2}
        assert reg.counter("artifact.miss").value == 2
        # Boot still succeeds: the bucket compiles live on first use.
        builds = dst.build_count
        out = dst.compile(1)(torch.from_numpy(_imgs(1)))
        assert out.shape == (1, 10) and dst.build_count == builds + 1

    def test_compat_fields_name_this_environment(self, tmp_path):
        meta = export_artifact(_engine(), tmp_path / "art", buckets=(1,))
        assert set(COMPAT_FIELDS) <= set(meta)
        assert meta["kernels"].startswith("libphonebit_")
        assert meta["cuda"] == torch.version.cuda

    def test_graph_fingerprint_mismatch(self, tmp_path):
        export_artifact(_engine(), tmp_path / "art", buckets=(1,))
        other = [BConv(3, 32, kernel=3, stride=1, pad=1, first=True),
                 Pool(2, 2), FloatDense(8 * 8 * 32, 10)]
        params = j_bnn.init_params(jax.random.key(0), [
            j_bnn.BConv(3, 32, kernel=3, stride=1, pad=1, first=True),
            j_bnn.Pool(2, 2), j_bnn.FloatDense(8 * 8 * 32, 10)])
        dst = PhoneBitEngine.from_trained(
            [{k: np.asarray(v) for k, v in p.items()} for p in params],
            other, HW, matmul_mode="torch", device="cpu")
        rep = load_artifact(dst, tmp_path / "art")
        assert rep["loaded"] == []
        assert any(r.startswith("fingerprint:") for r in rep["missed"][1])

    def test_bucket_subset_load(self, tmp_path):
        export_artifact(_engine(), tmp_path / "art", buckets=(1, 2, 4))
        rep = load_artifact(_engine(), tmp_path / "art", buckets=(2,))
        assert rep["loaded"] == [2] and not rep["missed"]

    def test_workload_wants_the_head(self, tmp_path):
        """An engine's artifact carries no head: a workload misses it."""
        wl = t_workloads.get("alexnet_imagenet", variant="tiny",
                             device="cpu", matmul_mode="torch")
        export_artifact(wl.engine.engine, tmp_path / "art", buckets=(1,))
        dst = t_workloads.get("alexnet_imagenet", variant="tiny",
                              device="cpu", matmul_mode="torch")
        rep = dst.engine.load_artifact(tmp_path / "art")
        assert rep["loaded"] == []
        assert any(r.startswith("head:") for r in rep["missed"][1])


# --------------------------------------------------------------------------
# integrity: a bad plan never reaches the executor
# --------------------------------------------------------------------------

def _replace_plan(art: pathlib.Path, data: bytes) -> None:
    (art / "b1.plan.json").write_bytes(data)
    meta = json.loads((art / "meta.json").read_text())
    meta["buckets"]["1"]["sha256"] = hashlib.sha256(data).hexdigest()
    (art / "meta.json").write_text(json.dumps(meta))


class TestIntegrity:
    def test_corrupted_plan_raises(self, tmp_path):
        export_artifact(_engine(), tmp_path / "art", buckets=(1,))
        plan = tmp_path / "art" / "b1.plan.json"
        data = bytearray(plan.read_bytes())
        data[len(data) // 2] ^= 0x01
        plan.write_bytes(bytes(data))
        with pytest.raises(ArtifactError, match="corrupted"):
            load_artifact(_engine(), tmp_path / "art")

    def test_unparsable_plan_raises(self, tmp_path):
        # sha-valid garbage: the checksum passes, the parse must not.
        export_artifact(_engine(), tmp_path / "art", buckets=(1,))
        _replace_plan(tmp_path / "art", b"not a plan at all")
        with pytest.raises(ArtifactError, match="unparsable"):
            load_artifact(_engine(), tmp_path / "art")

    def test_missing_plan_raises(self, tmp_path):
        export_artifact(_engine(), tmp_path / "art", buckets=(1,))
        (tmp_path / "art" / "b1.plan.json").unlink()
        with pytest.raises(ArtifactError, match="missing"):
            load_artifact(_engine(), tmp_path / "art")

    @pytest.mark.parametrize("edit", ["node", "backend", "region",
                                      "malformed"])
    def test_plan_that_does_not_fit_the_graph_raises(self, tmp_path, edit):
        export_artifact(_engine(), tmp_path / "art", buckets=(1,))
        plan = json.loads((tmp_path / "art" / "b1.plan.json").read_text())
        nid = next(iter(plan["backends"]))
        if edit == "node":
            plan["backends"]["999"] = plan["backends"][nid]
        elif edit == "backend":
            plan["backends"][nid] = "xla"
        elif edit == "region":
            plan["regions"] = [{"node_ids": [0, 1], "tile": {}}]
        else:
            del plan["tiles"]
        _replace_plan(tmp_path / "art", json.dumps(plan).encode())
        with pytest.raises(ArtifactError,
                           match="lacks|does not fit|malformed"):
            load_artifact(_engine(), tmp_path / "art")


# --------------------------------------------------------------------------
# the autotune winner table rides along
# --------------------------------------------------------------------------

def test_autotune_table_rides_along(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "0")   # no disk warm start
    export_artifact(_engine("auto"), tmp_path / "art", buckets=(1,))
    assert (tmp_path / "art" / "autotune.json").exists()
    # Adoption is checked against an isolated tuner: the engine's own
    # shares the process-wide caches, which a same-process load holds.
    tuner = autotune.Autotuner(cache={}, agnostic_cache={}, persist=False,
                               device="cpu")
    assert load_autotune_table(tmp_path / "art", tuner) > 0
    assert tuner.cache and tuner.agnostic_cache
    assert all(e.get("env") == autotune.env_stamp("cpu")
               for e in tuner.cache.values())
    # A table stamped by another toolchain is skipped, like a stale disk.
    table_path = tmp_path / "art" / "autotune.json"
    table = json.loads(table_path.read_text())
    for e in table.values():
        e["env"] = {"torch": "0.0.1", "cuda": None, "device": "cpu"}
    table_path.write_text(json.dumps(table))
    assert load_autotune_table(tmp_path / "art", autotune.Autotuner(
        cache={}, agnostic_cache={}, persist=False, device="cpu")) == 0


def test_auto_load_runs_no_tuner(tmp_path, monkeypatch):
    """After an ``"auto"`` load, serving every bucket asks the tuner
    nothing: no outcome at all, so no ``miss``."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "0")
    export_artifact(_engine("auto"), tmp_path / "art", buckets=(1, 2))
    dst = _engine("auto")
    with obs_metrics.use_registry() as reg:
        rep = load_artifact(dst, tmp_path / "art")
        for b in (1, 2):
            dst.cross_check(torch.from_numpy(_imgs(b)))
    assert rep["loaded"] == [1, 2]
    assert reg.events("autotune") == []


# --------------------------------------------------------------------------
# zero warm-up, end to end in a fresh process
# --------------------------------------------------------------------------

def test_fresh_subprocess_serves_from_artifact(tmp_path, monkeypatch):
    """A process that imports ``repro_torch`` alone boots a server from an
    ``"auto"`` artifact: both buckets load, the tuner records nothing,
    ``build_count`` stays flat while it serves, and its rows equal the
    exporting engine's at each request's bucket."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "0")
    src = _engine("auto")
    export_artifact(src, tmp_path / "art", buckets=(1, 2))
    imgs = _imgs(3, seed=5)
    # 3 requests through max_batch=2: a batch of 2, then a batch of 1.
    want = np.concatenate([src.compile(2)(torch.from_numpy(imgs[:2])),
                           src.compile(1)(torch.from_numpy(imgs[2:]))])
    np.savez(tmp_path / "io.npz", imgs=imgs, want=want,
             **{f"p{i}_{k}": v for i, p in enumerate(_params())
                for k, v in p.items()})
    script = textwrap.dedent("""
        import os, sys
        os.environ["REPRO_AUTOTUNE_CACHE"] = "0"
        sys.path.insert(0, {src!r})
        import numpy as np
        from repro_torch.core.bnn_model import BConv, FloatDense, Pool
        from repro_torch.obs import metrics
        from repro_torch.serving import InferenceServer, PhoneBitEngine

        io = np.load({io!r})
        params = [dict() for _ in range(3)]
        for key in io.files:
            if key.startswith("p"):
                i, name = key[1:].split("_", 1)
                params[int(i)][name] = io[key]
        spec = [BConv(3, 16, kernel=3, stride=1, pad=1, first=True),
                Pool(2, 2), FloatDense(8 * 8 * 16, 10)]
        eng = PhoneBitEngine.from_trained(params, spec, (16, 16),
                                          matmul_mode="auto", device="cpu")
        with metrics.use_registry() as reg:
            server = InferenceServer(eng, artifact={art!r}, buckets=(1, 2),
                                     max_batch=2)
            assert server.artifact_report["loaded"] == [1, 2], \\
                server.artifact_report
            builds = eng.build_count
            rs = [server.submit(i) for i in io["imgs"]]
            server.drain()
        assert [r.outcome for r in rs] == ["served"] * 3
        assert reg.events("autotune") == [], reg.events("autotune")
        assert eng.build_count == builds
        np.testing.assert_array_equal(np.stack([r.result for r in rs]),
                                      io["want"])
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                             "repro")]
        assert not bad, bad
        print("zero-warmup-ok")
    """).format(src=str(REPO / "src"), art=str(tmp_path / "art"),
                io=str(tmp_path / "io.npz"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, env=dict(os.environ))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "zero-warmup-ok" in r.stdout
