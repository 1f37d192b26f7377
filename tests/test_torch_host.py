"""Port parity for the host layer: ``config.py``, ``registry.py``,
``profiling.py`` and the package's entry points, against ``compv_tpu`` on
the same inputs (CPU, small sizes: a 96x128 textured scene as
examples/common.py makes it).

Covers what ``tests/test_config_profiling.py`` and the registry cases of
``tests/test_registry_svm_extra.py`` cover, plus:
* config files written by either package load in the other into equal
  configs, for all 19 names (each with every scalar field moved off its
  default);
* the repaired round trip: a ``MserConfig`` saved and loaded again is
  equal and runs ``mser_detect``; the reference's loaded one is unequal
  (its ``run_tiers`` comes back a list, which cannot be hashed);
* each registry function against the reference's on the same image:
  exact for FAST, ORB at one level (keypoints but orientation, descriptors),
  the edge maps and the matcher; ORB's orientation within 1e-4 deg (an ulp
  of atan2, see tests/test_torch_orb.py); MSER's integer fields exact and
  its variation within 1e-6 relative (tests/test_torch_mser.py).
"""
import dataclasses
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compv_tpu
import compv_tpu_torch
from compv_tpu import config as jconfig
from compv_tpu_torch import config, profiling, registry
from compv_tpu_torch.interop import config_from_reference, keypoints_to_numpy
from scipy import ndimage

NAMES = sorted(jconfig._ensure_registry())


@pytest.fixture(scope="module")
def img():
    """Blurred uniform noise (examples/common.py's textured_scene): corners
    everywhere, so every detector finds something at 96x128."""
    rs = np.random.default_rng(5)
    im = ndimage.gaussian_filter(
        rs.uniform(0, 255, (96, 128)).astype(np.float32), 1.5)
    return ((im - im.min()) / (np.ptp(im) + 1e-9) * 255).astype(np.uint8)


def _port_config(jcfg):
    """The port's counterpart of a reference config (``MatcherConfig``,
    which ``interop`` does not convert, field by field)."""
    if type(jcfg).__name__ == "MatcherConfig":
        from compv_tpu_torch.matchers.bruteforce import MatcherConfig
        return MatcherConfig(**dataclasses.asdict(jcfg))
    return config_from_reference(jcfg)


def _moved(cfg):
    """``cfg`` with every int, float and bool field off its default
    (nested configs too); strings and tuples stay."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _moved(v)
        elif isinstance(v, bool):
            out[f.name] = not v
        elif isinstance(v, int):
            out[f.name] = v + 3
        elif isinstance(v, float):
            out[f.name] = v * 1.5 + 0.25
    return dataclasses.replace(cfg, **out)


# ------------------------------------------------------------------ config

def test_registry_has_the_reference_names():
    reg = config._ensure_registry()
    assert sorted(reg) == NAMES and len(reg) == 19
    for name, cls in reg.items():
        assert cls.__name__ == jconfig._ensure_registry()[name].__name__
        assert isinstance(config.config_to_dict(cls()), dict)


def test_roundtrip_fast():
    from compv_tpu_torch.features.fast import FastConfig
    cfg = FastConfig(threshold=33, nms=False)
    assert config.config_from_dict("fast", config.config_to_dict(cfg)) == cfg


def test_json_file(tmp_path):
    from compv_tpu_torch.features.orb import OrbConfig
    p = str(tmp_path / "cfg.json")
    config.save_config(p, orb=OrbConfig(max_features=123))
    cfg = config.load_config(p, "orb")
    assert cfg.max_features == 123
    assert cfg.scale_factor == pytest.approx(0.83)
    assert config.load_config(p, "fast") == config.load_config(p, "fast")


def test_yaml_parse_equals_reference():
    y = """
# comment
fast:
  threshold: 25
  nms: true
orb:
  max_features: 500
  scale_factor: 0.9
  name: 'x'
frontend:
  orb:
    max_features: 2000
    levels: 8
  homography:
    threshold: 9.5
  ratio: 0.7
"""
    d = config.parse_simple_yaml(y)
    assert d == jconfig.parse_simple_yaml(y)
    assert d["fast"]["threshold"] == 25 and d["fast"]["nms"] is True
    assert d["orb"]["scale_factor"] == 0.9 and d["orb"]["name"] == "x"
    assert d["frontend"]["orb"] == {"max_features": 2000, "levels": 8}


def test_yaml_file_nested(tmp_path):
    from compv_tpu_torch.calib.homography import HomographyConfig
    from compv_tpu_torch.features.orb import OrbConfig
    from compv_tpu_torch.slam.frontend import FrontendConfig
    p = str(tmp_path / "cfg.yaml")
    with open(p, "w") as f:
        f.write("fast:\n  threshold: 42\nfrontend:\n  orb:\n"
                "    max_features: 2000\n    levels: 8\n  homography:\n"
                "    threshold: 30.0\n")
    assert config.load_config(p, "fast").threshold == 42
    assert config.load_config(p, "frontend") == FrontendConfig(
        orb=OrbConfig(max_features=2000, levels=8),
        homography=HomographyConfig())


def test_mser_roundtrip_is_repaired(tmp_path, img):
    """The reference rebuilds ``run_tiers`` as a list: its loaded config is
    unequal and unhashable. The port's is equal and runs."""
    from compv_tpu.features.mser import MserConfig as JMserConfig
    from compv_tpu_torch.features.mser import MserConfig, mser_detect
    p = str(tmp_path / "mser.json")
    config.save_config(p, mser=MserConfig(run_tiers=(64, 200)))
    back = config.load_config(p, "mser")
    assert back == MserConfig(run_tiers=(64, 200))
    assert isinstance(back.run_tiers, tuple)
    hash(back)
    want = mser_detect(torch.from_numpy(img), MserConfig(run_tiers=(64, 200)))
    got = mser_detect(torch.from_numpy(img), back)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    jconfig.save_config(p, mser=JMserConfig())
    jback = jconfig.load_config(p, "mser")
    assert jback != JMserConfig() and isinstance(jback.run_tiers, list)
    with pytest.raises(TypeError):
        hash(jback)
    assert config.load_config(p, "mser") == MserConfig()


def test_tuples_inside_lists_come_back_as_tuples():
    from compv_tpu_torch.features.mser import MserConfig
    back = config.config_from_dict(MserConfig, {"run_tiers": [[1, 2], 3]})
    assert back.run_tiers == ((1, 2), 3)


@pytest.mark.parametrize("name", NAMES)
def test_config_files_cross_packages(tmp_path, name):
    """A file the reference saves loads in the port into the port's
    counterpart of the reference's config, and the other way round."""
    jcfg = _moved(jconfig._ensure_registry()[name]())
    want = _port_config(jcfg)
    assert want != config._ensure_registry()[name]()
    p = str(tmp_path / f"{name}.json")
    jconfig.save_config(p, **{name: jcfg})
    assert config.load_config(p, name) == want

    config.save_config(p, **{name: want})
    with open(p) as f:
        assert json.load(f) == json.loads(
            json.dumps({name: jconfig.config_to_dict(jcfg)}))
    back = jconfig.load_config(p, name)
    if name == "mser":       # the reference's fault: run_tiers as a list
        assert jconfig.config_to_dict(back) == {
            **jconfig.config_to_dict(jcfg), "run_tiers": list(jcfg.run_tiers)}
    else:
        assert back == jcfg


# ---------------------------------------------------------------- registry

def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_registry_lists_and_raises_as_the_reference():
    assert registry.list_algorithms() == compv_tpu.list_algorithms()
    for fn in (registry.create_detector, registry.create_edge_detector,
               registry.create_matcher):
        with pytest.raises(KeyError):
            fn("sift")


@pytest.mark.parametrize("name,overrides", [
    ("fast", {"threshold": 30}), ("orb", {"levels": 1, "max_features": 200}),
    ("mser", {})])
def test_create_detector_matches_reference(img, name, overrides):
    fn, cfg = registry.create_detector(name, **overrides)
    jfn, jcfg = compv_tpu.create_detector(name, **overrides)
    assert cfg == _port_config(jcfg)
    got = fn(torch.from_numpy(img), cfg)
    want = jfn(jnp.asarray(img), jcfg)
    if name == "fast":
        kp, jkp = got, want
    elif name == "orb":
        kp, jkp = got.keypoints, want.keypoints
        np.testing.assert_array_equal(got.descriptors.numpy(),
                                      np.asarray(want.descriptors))
    else:
        for field in got._fields:
            g, w = _np(getattr(got, field)), _np(getattr(want, field))
            if field == "variation":
                np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
                fin = np.isfinite(w)
                np.testing.assert_allclose(g[fin], w[fin], rtol=1e-6)
            else:
                np.testing.assert_array_equal(g, w, err_msg=field)
        assert int(got.valid.sum()) > 0
        return
    assert int(kp.count()) > 0
    for field, g in keypoints_to_numpy(kp).items():
        w = np.asarray(getattr(jkp, field))
        if field == "orientation":
            np.testing.assert_allclose(g, w, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("name", ["sobel", "scharr", "prewitt", "canny"])
def test_create_edge_detector_matches_reference(img, name):
    fn, cfg = registry.create_edge_detector(name)
    jfn, jcfg = compv_tpu.create_edge_detector(name)
    assert (cfg is None) == (jcfg is None)
    got = fn(torch.from_numpy(img), cfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(img), jcfg)))
    if name == "canny":
        assert set(np.unique(got)) <= {0, 255}


def test_create_matcher_matches_reference():
    fn, cfg = registry.create_matcher("bruteforce")
    jfn, jcfg = compv_tpu.create_matcher("bruteforce")
    assert cfg == _port_config(jcfg)
    rs = np.random.default_rng(0)
    t = rs.integers(0, 2, (10, 256)).astype(np.uint8)
    q = t ^ (rs.random((10, 256)) < 0.1).astype(np.uint8)
    m = fn(torch.from_numpy(q), torch.from_numpy(t), cfg)
    jm = jfn(jnp.asarray(q), jnp.asarray(t), jcfg)
    np.testing.assert_array_equal(m.train_idx[0].numpy(), np.arange(10))
    for field in m._fields:
        np.testing.assert_array_equal(_np(getattr(m, field)),
                                      np.asarray(getattr(jm, field)))


def test_package_entry_points():
    for name in ("image", "features", "matchers", "calib", "math", "ml",
                 "io", "viz", "slam", "create_detector", "create_matcher",
                 "create_edge_detector", "list_algorithms", "init", "deinit",
                 "Keypoints", "Matches", "Lines", "require_cuda"):
        assert hasattr(compv_tpu_torch, name), name
    assert compv_tpu_torch.create_detector is registry.create_detector
    threads = torch.get_num_threads()
    try:
        assert compv_tpu_torch.init() is None
        compv_tpu_torch.init(num_threads=1)
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(threads)
    assert compv_tpu_torch.deinit() is None
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


# --------------------------------------------------------------- profiling

def test_timer():
    t = profiling.Timer()
    with t.section("a"):
        _ = sum(range(1000))
    with t.section("a", block_on=torch.ones(3)):
        pass
    assert t.counts["a"] == 2 and t.totals["a"] >= 0
    assert "a:" in t.report()


def test_synchronize_walks_the_tree():
    """Results on the CPU need no wait: the walk finds no CUDA device in
    tensors, NamedTuples, lists and dicts (tests/test_torch_cuda.py checks
    the card)."""
    from compv_tpu_torch.core.types import Keypoints
    tree = {"kp": Keypoints.empty(4), "x": [torch.zeros(2), (1, "a")],
            "n": None}
    assert profiling._cuda_devices(tree, set()) == set()
    profiling._synchronize(tree)
    t = profiling.Timer()
    filled = []
    with t.section("fill", block_on=filled):
        filled.append(Keypoints.empty(2))
    assert t.counts["fill"] == 1


def test_trace_on_cpu_writes_a_chrome_trace(tmp_path):
    """The window's program spans are in the file too, on a row of their
    own, on the trace's clock: they hold the ops run inside them."""
    assert not profiling.spans.on
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.span("outer"):
            with profiling.span("inner", level=3):
                torch.ones(64).add_(1)
    assert not profiling.spans.on and profiling.spans.take() == []
    path = prof.trace_path
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::add_" in str(e.get("name")) for e in events)
    assert [r.name for r in prof.spans] == ["inner", "outer"]
    spans = {e["name"]: e for e in events if e.get("cat") == "compv_span"}
    assert set(spans) == {"inner", "outer"}
    assert spans["inner"]["args"]["level"] == 3
    assert spans["inner"]["tid"] == spans["outer"]["tid"]
    (add,) = [e for e in events if e.get("name") == "aten::add_"]
    for e in spans.values():
        assert e["ts"] <= add["ts"] + 1000                 # µs; 1 ms of slack
        assert add["ts"] + add["dur"] <= e["ts"] + e["dur"] + 1000


def test_window_shortfall_names_the_missing_kernels():
    names = ["void (anonymous namespace)::fast_kernel<9, 32, false>("
             "unsigned char const*, int)",
             "(anonymous namespace)::label_tiles(unsigned char const*, int)",
             "void at::native::vectorized_elementwise_kernel<4>(int)",
             "my_fast_kernel_copy(int)"]
    launched = {"fast_kernel": 2, "label_tiles": 1, "merge_seeded": 0}
    assert profiling.window_shortfall(launched, names) == {
        "fast_kernel": (2, 1)}
    assert profiling.window_shortfall({"fast_kernel": 1}, names) == {}
    assert profiling.window_shortfall(
        {"fast_kernel": 1}, ["void fast_kernel<9, 16, true>(int)"]) == {}
    assert set(profiling.hand_kernel_launches()) == {
        "fast_kernel", "label_tiles", "merge_seeded", "compact",
        "sht_accumulate", "strip_counts", "orb_orient", "level_areas"}


class _Event:
    def __init__(self, name):
        self._name = name

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA


class _ShortProfile:
    """A stand-in for torch.profiler.profile whose window recorded one K1
    kernel, whatever ran in it."""

    def __init__(self, activities):
        self.profiler = self
        self.kineto_results = self

    def events(self):
        return [_Event("void fast_kernel<9, 16, false>(unsigned char "
                       "const*, int, int)")]

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_trace_warns_when_its_window_drops_launches(tmp_path, monkeypatch):
    """On the card, a window holding fewer K1 kernels than K1's counter
    grew in it warns and says so; one holding them all does not."""
    from compv_tpu_torch.ops.kernels import fast_kernel
    monkeypatch.setattr(torch.profiler, "profile", _ShortProfile)
    monkeypatch.setattr(profiling, "require_cuda", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling, "_first_kernel", lambda: None)
    monkeypatch.setattr(fast_kernel, "launches", 0)
    with pytest.warns(RuntimeWarning, match="fast_kernel"):
        with profiling.trace(str(tmp_path)) as prof:
            fast_kernel.launches += 2       # two launches, one traced
    assert prof.shortfall == {"fast_kernel": (2, 1)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with profiling.trace(str(tmp_path)) as prof:
            fast_kernel.launches += 1
    assert prof.shortfall == {}


def test_card_entry_points_need_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checked on the card by tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError):
        profiling.device_memory_stats()
    with pytest.raises(RuntimeError):
        with profiling.trace(str(tmp_path)):
            pass


def test_memory_stats_keys_as_the_reference():
    from compv_tpu.profiling import device_memory_stats
    s = profiling.device_memory_stats(device="cpu")
    assert len(s) == 1
    assert set(s[0]) == set(device_memory_stats()[0])
    assert s[0]["bytes_in_use"] == -1 and s[0]["bytes_limit"] == -1


def test_log_sinks_and_levels():
    lines = []
    lg = profiling.Log()
    lg.add_sink("warn", lines.append)
    lg.warn("careful")
    lg.verbose("hidden")  # below level
    assert len(lines) == 1 and "careful" in lines[0]
    lg.level = "error"
    lg.warn("dropped")
    assert len(lines) == 1


def test_timed_prints(capsys):
    with profiling.timed("block"):
        pass
    assert "block:" in capsys.readouterr().out
