"""Port parity: weights carried across from the JAX package.

The port's ``convert`` of the JAX package's latent params (handed over as
numpy) must equal the JAX ``convert`` word for word, and the port's
``load_artifact`` must read a JAX-written ``.npz`` into the same arrays.
"""

import numpy as np
import pytest
import torch

from repro import workloads as j_workloads
from repro.core import converter as j_conv
from repro.core import layer_integration as j_li
from repro_torch.core import converter as t_conv
from repro_torch.core import layer_integration as t_li

NAMES = ("alexnet_imagenet", "vgg16_imagenet", "yolov2_tiny_voc")


def jax_params(name: str, variant: str = "tiny", seed: int = 3):
    wl = j_workloads.get(name, variant=variant, seed=seed)
    return wl, [{k: np.asarray(v) for k, v in p.items()} for p in wl.params]


def assert_same_artifact(t_packed, j_packed) -> None:
    assert len(t_packed) == len(j_packed)
    for i, (tl, jl) in enumerate(zip(t_packed, j_packed)):
        assert set(tl) == set(jl), (i, set(tl), set(jl))
        for k, jv in jl.items():
            tv = tl[k]
            if isinstance(jv, j_li.IntegratedParams):
                assert isinstance(tv, t_li.IntegratedParams)
                for f in ("threshold", "sign_flip"):
                    a, b = getattr(tv, f), np.asarray(getattr(jv, f))
                    assert a.numpy().dtype == b.dtype, (i, k, f)
                    np.testing.assert_array_equal(a.numpy(), b,
                                                  err_msg=f"{i}.{k}.{f}")
            elif k == "c_per_pos":    # layout metadata: compare the value
                assert int(tv) == int(jv), (i, k)
            else:
                a = tv.numpy() if torch.is_tensor(tv) else np.asarray(tv)
                b = np.asarray(jv)
                assert a.dtype == b.dtype, (i, k, a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b, err_msg=f"{i}.{k}")


def port_spec(spec) -> list:
    """The port's spec objects with the reference spec's fields."""
    from repro_torch.core import bnn_model as t_bnn

    return [getattr(t_bnn, type(l).__name__)(**vars(l)) for l in spec]


@pytest.mark.parametrize("name", NAMES)
def test_convert_matches_reference(name):
    from repro_torch import workloads as t_workloads

    wl, params = jax_params(name)
    t_wl = t_workloads.get(name, variant="tiny", device="cpu", params=params)
    assert t_wl.spec == port_spec(wl.spec) and t_wl.input_hw == wl.input_hw
    j_packed = j_conv.convert(wl.params, wl.spec, wl.input_hw)
    t_packed = t_conv.convert(params, t_wl.spec, t_wl.input_hw)
    assert_same_artifact(t_packed, j_packed)
    assert t_conv.model_bytes(t_packed) == j_conv.model_bytes(j_packed)


def test_convert_with_bias_matches_reference():
    """Layers carrying a bias fold it into the threshold identically."""
    wl, params = jax_params("alexnet_imagenet")
    rng = np.random.default_rng(0)
    for p in params:
        if "gamma" in p:
            p["b"] = rng.uniform(-3, 3, p["gamma"].shape).astype(np.float32)
    assert_same_artifact(
        t_conv.convert(params, port_spec(wl.spec), wl.input_hw),
        j_conv.convert(params, wl.spec, wl.input_hw))


def test_paper_alexnet_convert_matches_reference():
    """Full width: the slice's model, carried across word for word."""
    from repro_torch.models import paper_nets as t_nets

    wl, params = jax_params("alexnet_imagenet", variant="paper", seed=0)
    spec, _ = t_nets.get("alexnet")
    assert spec == port_spec(wl.spec)
    assert_same_artifact(t_conv.convert(params, spec, wl.input_hw),
                         j_conv.convert(wl.params, wl.spec, wl.input_hw))


@pytest.mark.parametrize("name", ("alexnet_imagenet", "yolov2_tiny_voc"))
def test_load_artifact_reads_reference_npz(name, tmp_path):
    wl, params = jax_params(name)
    j_packed = j_conv.convert(wl.params, wl.spec, wl.input_hw)
    path = str(tmp_path / "ref.npz")
    j_conv.save_artifact(path, j_packed)
    assert_same_artifact(t_conv.load_artifact(path),
                         j_conv.load_artifact(path))
    # An engine booted from the reference's file serves what an engine
    # converted from the same params serves.
    from repro_torch.serving import PhoneBitEngine

    spec = port_spec(wl.spec)
    h, w = wl.input_hw
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, h, w, 3), dtype=np.uint8))
    booted = PhoneBitEngine.from_artifact(path, spec, wl.input_hw,
                                          device="cpu", matmul_mode="torch")
    fresh = PhoneBitEngine.from_trained(params, spec, wl.input_hw,
                                        device="cpu", matmul_mode="torch")
    assert torch.equal(booted(x), fresh(x))
    # ... and the reference reads the port's file back the same way.
    path2 = str(tmp_path / "port.npz")
    t_conv.save_artifact(path2, t_conv.load_artifact(path))
    assert_same_artifact(t_conv.load_artifact(path2),
                         j_conv.load_artifact(path2))
