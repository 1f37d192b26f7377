"""The reference's counts on chip_smoke.py's HOG -> SVM window classifier.

Computes ``compv_tpu.features.hog.hog_descriptor`` of bench.py's 720x1282
scene with ``HogConfig()``, cuts every 128 x 64 window at a one-cell stride
(``chip_smoke.hog_windows``: 11,475 windows of 3,780 values), labels each
by whether its centre lies in the scene's checkerboard patch
(``chip_smoke.hog_window_labels``) and trains on the 2,048 windows that
``chip_smoke.hog_train_index`` draws (numpy seed 0). Then, all on the CPU
with JAX: ``svm_train`` with the RBF ``SvmConfig()`` and with the linear
kernel, ``svm_decision`` on every window, ``pca_compute`` of all windows
to 64 components and a 5-NN vote (``knn_search``) of each window among the
training windows in PCA space.
Prints one JSON line: the windows each classifier gets right, the smallest
RBF |decision|, and the PCA's eigenvalues (the ``HOG_SVM_REF`` constants of
chip_smoke.py's phase 17). From the repository root, on a machine with
JAX (about a minute):

    python3 scripts/hog_svm_reference.py
"""
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from compv_tpu.features.hog import HogConfig, hog_descriptor  # noqa: E402
from compv_tpu.math.pca import pca_compute, pca_project  # noqa: E402
from compv_tpu.ml.knn import knn_build, knn_search  # noqa: E402
from compv_tpu.ml.svm import SvmConfig, svm_decision, svm_train  # noqa: E402


def load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    smoke = load("chip_smoke", "chip_smoke.py")
    gray = load("bench", "bench.py")._images()[0]
    desc = np.array(hog_descriptor(jnp.asarray(gray), HogConfig()))
    windows = jnp.asarray(smoke.hog_windows(torch.from_numpy(desc)).numpy())
    labels = smoke.hog_window_labels(desc.shape)
    train = smoke.hog_train_index(windows.shape[0])
    x, y = windows[train], jnp.asarray(labels[train])

    def correct(pred) -> int:
        return int((np.asarray(pred) == labels).sum())

    rbf = svm_train(x, y, SvmConfig())
    dec = np.asarray(svm_decision(rbf, windows))
    lin = svm_train(x, y, SvmConfig(kernel="linear"))
    dec_lin = np.asarray(svm_decision(lin, windows))
    pca = pca_compute(windows, 64)
    idx, _ = knn_search(knn_build(pca_project(pca, x)),
                        pca_project(pca, windows), 5)
    votes = np.asarray(y)[np.asarray(idx)].sum(axis=1)
    vals = np.asarray(pca.values)
    print(json.dumps({
        "jax": jax.__version__, "descriptor": list(desc.shape),
        "windows": int(windows.shape[0]), "dim": int(windows.shape[1]),
        "positive_share": float((labels > 0).mean()),
        "rbf_correct": correct(np.where(dec >= 0, 1.0, -1.0)),
        "rbf_min_abs_decision": float(np.abs(dec).min()),
        "linear_correct": correct(np.where(dec_lin >= 0, 1.0, -1.0)),
        "knn5_correct": correct(np.where(votes >= 0, 1.0, -1.0)),
        "pca_eig_first": float(vals[0]), "pca_eig_64th": float(vals[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
