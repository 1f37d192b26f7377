"""Port parity of ``image/remap.py`` and ``io/serialize.py`` against
``compv_tpu`` on the same numpy inputs (CPU).

Tolerances: warps and remaps of u8 images are exact, pixel for pixel (the
same f32 arithmetic; the differing pixels are counted, and the count must
be 0: XLA:CPU contracts no product of these expressions into a fused
multiply-add here); float images to 1e-4 relative. Serialization round
trips are exact, and a tree one package writes to .npz loads in the other.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.image import remap as jr
from compv_tpu.io import serialize as js
from compv_tpu_torch.image import remap as tr
from compv_tpu_torch.io import serialize as ts


def _img(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


HOMOGRAPHIES = {
    "identity": np.eye(3),
    "shift_scale": np.array([[0.9, 0.05, 12.3], [-0.04, 1.1, -7.5],
                             [0.0, 0.0, 1.0]]),
    "perspective": np.array([[1.02, 0.1, -20.0], [0.03, 0.95, 8.0],
                             [2e-4, -3e-4, 1.0]]),
    # the renderer's texture warp: plane coords scaled up 2.5x and shifted
    "renderer_like": np.array([[2.5, 0.02, 140.0], [-0.01, 2.45, 95.0],
                               [1e-5, 2e-5, 1.0]]),
}


@pytest.mark.parametrize("name", sorted(HOMOGRAPHIES))
@pytest.mark.parametrize("channels", [1, 3])
def test_warp_perspective_u8(name, channels):
    shape = (97, 131) if channels == 1 else (97, 131, 3)
    img = _img(shape, 1)
    h = HOMOGRAPHIES[name].astype(np.float32)
    want = np.asarray(jr.warp_perspective(jnp.asarray(img), jnp.asarray(h),
                                          80, 110))
    got = tr.warp_perspective(torch.from_numpy(img), torch.from_numpy(h),
                              80, 110).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int((got != want).sum()) == 0


def test_warp_perspective_float_and_fill():
    img = _img((50, 60), 2).astype(np.float32) / 7.0
    h = HOMOGRAPHIES["perspective"].astype(np.float32)
    want = np.asarray(jr.warp_perspective(jnp.asarray(img), jnp.asarray(h),
                                          64, 64, fill=3.5))
    got = tr.warp_perspective(torch.from_numpy(img), torch.from_numpy(h),
                              64, 64, fill=3.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (got == 3.5).any()


def test_warp_affine_and_remaps():
    img = _img((40, 52), 3)
    m = np.array([[0.8, -0.2, 9.0], [0.15, 1.1, -3.0]], np.float32)
    want = np.asarray(jr.warp_affine(jnp.asarray(img), jnp.asarray(m), 45,
                                     50))
    got = tr.warp_affine(torch.from_numpy(img), torch.from_numpy(m), 45,
                         50).numpy()
    assert int((got != want).sum()) == 0
    rs = np.random.default_rng(4)
    mx = rs.uniform(-3, 55, (30, 33)).astype(np.float32)
    my = rs.uniform(-3, 43, (30, 33)).astype(np.float32)
    mx[0, :4] = [0.5, 1.5, 2.5, 51.0]      # round-half-even ties
    for fn_j, fn_t in ((jr.remap_bilinear, tr.remap_bilinear),
                       (jr.remap_nearest, tr.remap_nearest)):
        want = np.asarray(fn_j(jnp.asarray(img), jnp.asarray(mx),
                               jnp.asarray(my), 9.0))
        got = fn_t(torch.from_numpy(img), torch.from_numpy(mx),
                   torch.from_numpy(my), 9.0).numpy()
        assert int((got != want).sum()) == 0


# ---------------------------------------------------------------- serialize

def test_mat_json_round_trip(tmp_path):
    a = np.arange(12, dtype=np.int16).reshape(3, 4)
    b = np.linspace(0, 1, 5).astype(np.float32)
    assert ts.array_to_json(a) == js.array_to_json(a)
    assert ts.array_to_json(torch.from_numpy(b)) == js.array_to_json(b)
    path = str(tmp_path / "m.json")
    ts.save_mat_json(path, a=a, b=torch.from_numpy(b))
    for load in (ts.load_mat_json, js.load_mat_json):
        back = load(path)
        np.testing.assert_array_equal(back["a"], a)
        np.testing.assert_array_equal(back["b"], b)
        assert back["a"].dtype == a.dtype and back["b"].dtype == b.dtype


def test_npz_trees_cross_packages(tmp_path):
    tree = {"z": np.ones((2, 2), np.float32),
            "a": [np.arange(3), (np.zeros(1, bool), np.full(2, 7, np.int32))]}
    like = {"z": 0, "a": [0, (0, 0)]}
    p_port, p_ref = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    ts.save_npz(p_port, tree)
    js.save_npz(p_ref, tree)
    for path in (p_port, p_ref):
        back = ts.load_npz(path, like)
        np.testing.assert_array_equal(back["z"], tree["z"])
        np.testing.assert_array_equal(back["a"][0], tree["a"][0])
        np.testing.assert_array_equal(back["a"][1][1], tree["a"][1][1])
    ref = js.load_npz(p_port, tree)
    np.testing.assert_array_equal(ref["a"][1][0], tree["a"][1][0])


def test_checkpoint_round_trip(tmp_path):
    state = {"cams": np.random.default_rng(0).normal(size=(4, 6)).astype(
        np.float32), "ok": np.array([True, False]),
        "n": torch.tensor([3], dtype=torch.int32)}
    path = ts.save_checkpoint(str(tmp_path / "ck"), 12, state)
    assert os.path.basename(path) == "step_12.pt"
    back = ts.load_checkpoint(path)
    assert set(back) == set(state)
    np.testing.assert_array_equal(back["cams"].numpy(), state["cams"])
    assert back["ok"].dtype == torch.bool and back["n"].tolist() == [3]
