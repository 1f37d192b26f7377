"""The f32 cos / sin tables of the Hough transforms, as the reference
computes them.

``compv_tpu/features/hough.py:75-77`` takes ``jnp.cos`` / ``jnp.sin`` of
``arange(n_theta, f32) * f32(theta_step)`` on XLA:CPU. That polynomial is
not the one ``torch.cos`` / ``torch.sin`` use, nor a correctly rounded one:
at 1 degree 6 cos and 13 sin values differ from torch's, and a float64
table rounded to f32 still differs in 1 + 3 values (2 + 9 at 0.5 degree).
One ulp moves a vote whose rho sits on a half-bin boundary, so the SHT
accumulator is bit-equal to the reference only with the reference's table.
It is carried here as data, as f32 bit patterns (big-endian hex), for the
two theta steps the package uses (``HoughShtConfig`` 1.0 degree,
``HoughKhtConfig`` 0.5 degree); ``tests/test_torch_hough_kernel.py``
regenerates both with ``jnp.cos`` / ``jnp.sin`` and checks every bit.

Any other step gets the float64 table rounded to f32: a divergence by
design, recorded in ROADMAP.md Queue 3.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["theta_count", "theta_table"]

_COS_1 = (
    "3f8000003f7ff6053f7fd8143f7fa62f3f7f605c3f7f069e3f7e98fd3f7e17813f7d8235"
    "3f7cd9253f7c1c5c3f7b4beb3f7a67e23f7970513f78654d3f7746ea3f76153f3f74d064"
    "3f7378713f720d813f708fb23f6eff203f6d5bec3f6ba6353f69de1d3f6803c93f66175e"
    "3f6419013f6208da3f5fe7143f5db3d73f5b6f513f5919ae3f56b31d3f543bcf3f51b3f3"
    "3f4f1bbd3f4c73613f49bb133f46f3093f441b7d3f4134a63f3e3ebd3f3b39ff3f3826a7"
    "3f3504f33f31d5223f2e97723f2b4c243f27f37c3f248dbb3f211b253f1d9bfe3f1a108d"
    "3f1679193f12d5e83f0f27443f0b6d773f07a8ca3f03d9893effffff3ef838f63ef05e95"
    "3ee871723ee0722f3ed8616b3ed03fc83ec80deb3ebfcc713eb77c023eaf1d443ea6b0de"
    "3e9e37793e95b1c13e8d20583e8483ef3e77ba603e6659913e54e6cb3e4363733e31d0d7"
    "3e20305d3e0e83653df996a03dd612ff3db27ebe3d8edc803d565e3f3d0ef2c63c8ef84d"
    "b33bbd2ebc8ef83cbd0ef2bdbd565e36bd8edc7cbdb27eb9bdd6130bbdf9969bbe0e8363"
    "be20305abe31d0d5be436371be54e6c9be66598fbe77ba5ebe8483eebe8d2057be95b1c0"
    "be9e3778bea6b0ddbeaf1d43beb77c01bebfcc70bec80deabed03fc7bed8616ebee0722e"
    "bee8716ebef05e94bef838f5bf000001bf03d988bf07a8cbbf0b6d77bf0f2743bf12d5e8"
    "bf167917bf1a108ebf1d9bfdbf211b23bf248dbbbf27f37bbf2b4c26bf2e9771bf31d520"
    "bf3504f3bf3826a6bf3b3a00bf3e3ebdbf4134a7bf441b7dbf46f308bf49bb13bf4c7360"
    "bf4f1bbebf51b3f3bf543bcdbf56b31dbf5919adbf5b6f51bf5db3d7bf5fe715bf6208da"
    "bf641900bf66175ebf6803c9bf69de1ebf6ba635bf6d5bebbf6eff21bf708fb2bf720d82"
    "bf737870bf74d063bf76153fbf7746eabf78654dbf797051bf7a67e2bf7b4bebbf7c1c5c"
    "bf7cd925bf7d8235bf7e1781bf7e98fdbf7f069dbf7f605cbf7fa62fbf7fd814bf7ff605")

_SIN_1 = (
    "000000003c8ef8593d0ef2c63d565e3b3d8edc7b3db27eb53dd613053df996a33e0e8365"
    "3e20305c3e31d0d43e43636f3e54e6ce3e6659923e77ba603e8483ee3e8d20573e95b1be"
    "3e9e377a3ea6b0df3eaf1d433eb77c013ebfcc703ec80de93ed03fc93ed8616c3ee0722f"
    "3ee871713ef05e943ef838f73f0000003f03d9893f07a8ca3f0b6d773f0f27443f12d5e8"
    "3f1679183f1a108c3f1d9bfe3f211b243f248dba3f27f37c3f2b4c253f2e97723f31d522"
    "3f3504f33f3826a73f3b39ff3f3e3ebe3f4134a53f441b7d3f46f3093f49bb123f4c7361"
    "3f4f1bbd3f51b3f33f543bce3f56b31d3f5919ae3f5b6f513f5db3d83f5fe7143f6208da"
    "3f6419013f66175e3f6803ca3f69de1e3f6ba6343f6d5bec3f6eff203f708fb23f720d81"
    "3f7378713f74d0633f76153f3f7746ea3f78654d3f7970513f7a67e23f7b4beb3f7c1c5c"
    "3f7cd9253f7d82353f7e17813f7e98fd3f7f069e3f7f605c3f7fa62f3f7fd8143f7ff605"
    "3f8000003f7ff6053f7fd8143f7fa62f3f7f605c3f7f069e3f7e98fd3f7e17813f7d8235"
    "3f7cd9253f7c1c5c3f7b4beb3f7a67e23f7970513f78654d3f7746ea3f76153f3f74d063"
    "3f7378713f720d823f708fb23f6eff213f6d5bec3f6ba6353f69de1e3f6803c93f66175e"
    "3f6419023f6208da3f5fe7143f5db3d73f5b6f513f5919ad3f56b31d3f543bcf3f51b3f2"
    "3f4f1bbd3f4c73603f49bb133f46f30b3f441b7d3f4134a63f3e3ebd3f3b39ff3f3826a9"
    "3f3504f33f31d5233f2e97713f2b4c253f27f37b3f248dbb3f211b263f1d9bfd3f1a108e"
    "3f1679173f12d5e83f0f27463f0b6d773f07a8cb3f03d9883f0000013ef838f53ef05e94"
    "3ee871743ee0722e3ed8616e3ed03fc73ec80dea3ebfcc733eb77c003eaf1d463ea6b0dd"
    "3e9e377b3e95b1c33e8d20573e8483f13e77ba5d3e6659963e54e6c83e4363703e31d0dc"
    "3e20305a3e0e836a3df9969a3dd613093db27ec83d8edc7b3d565e533d0ef2ba3c8ef875")

_COS_05 = (
    "3f8000003f7ffd813f7ff6053f7fe98b3f7fd8143f7fc1a03f7fa62f3f7f85c33f7f605c"
    "3f7f35f93f7f069e3f7ed2493f7e98fd3f7e5aba3f7e17813f7dcf553f7d82353f7d3025"
    "3f7cd9253f7c7d373f7c1c5c3f7bb6983f7b4beb3f7adc583f7a67e23f79ee893f797051"
    "3f78ed3c3f78654d3f77d8863f7746ea3f76b07c3f76153f3f7575363f74d0643f7426cb"
    "3f7378713f72c5573f720d813f7150f43f708fb23f6fc9c03f6eff203f6e2fd93f6d5bec"
    "3f6c835e3f6ba6353f6ac4733f69de1d3f68f3393f6803c93f670fd43f66175e3f651a6b"
    "3f6419013f6313243f6208da3f60fa293f5fe7143f5ecfa13f5db3d73f5c93ba3f5b6f51"
    "3f5a46a03f5919ae3f57e8803f56b31d3f55798b3f543bcf3f52f9ef3f51b3f33f5069e0"
    "3f4f1bbd3f4dc9913f4c73613f4b19343f49bb133f4859023f46f3093f4589313f441b7d"
    "3f42a9f73f4134a63f3fbb903f3e3ebd3f3cbe353f3b39ff3f39b2233f3826a73f369795"
    "3f3504f33f336eca3f31d5223f3038023f2e97723f2cf37b3f2b4c243f29a1783f27f37c"
    "3f26423a3f248dbb3f22d6063f211b253f1f5d1f3f1d9bfe3f1bd7ca3f1a108d3f18464e"
    "3f1679193f14a8f33f12d5e83f1100003f0f27443f0d4bbe3f0b6d773f098c773f07a8ca"
    "3f05c2783f03d9893f01ee093effffff3efc1ef13ef838f63ef44e273ef05e953eec6a50"
    "3ee871723ee474093ee0722f3edc6bf53ed8616b3ed452ad3ed03fc83ecc28d73ec80deb"
    "3ec3ef153ebfcc713ebba60c3eb77c023eb34e603eaf1d443eaae8bd3ea6b0de3ea275c3"
    "3e9e37793e99f61d3e95b1c13e916a753e8d20583e88d3773e8483ef3e8031cd3e77ba60"
    "3e6f0c513e6659913e5da25b3e54e6cb3e4c271c3e4363733e3a9bf33e31d0d73e29023b"
    "3e20305d3e175b5e3e0e83653e05a8ac3df996a03de7d71a3dd612ff3dc44ac83db27ebe"
    "3da0af283d8edc803d7a0e003d565e3f3d32aa503d0ef2c63cd671233c8ef84d3c0ef9da"
    "b33bbd2ebc0ef9b8bc8ef83cbcd67112bd0ef2bdbd32aa48bd565e36bd7a0df7bd8edc7c"
    "bda0af24bdb27eb9bdc44ac4bdd6130bbde7d716bdf9969bbe05a8aabe0e8363be175b5c"
    "be20305abe290239be31d0d5be3a9bf0be436371be4c271abe54e6c9be5da259be66598f"
    "be6f0c4fbe77ba5ebe8031d0be8483eebe88d376be8d2057be916a74be95b1c0be99f61c"
    "be9e3778bea275c2bea6b0ddbeaae8bcbeaf1d43beb34e63beb77c01bebba60bbebfcc70"
    "bec3ef14bec80deabecc28d6bed03fc7bed452acbed8616ebedc6bf4bee0722ebee47408"
    "bee8716ebeec6a52bef05e94bef44e26bef838f5befc1eedbf000001bf01ee09bf03d988"
    "bf05c276bf07a8cbbf098c78bf0b6d77bf0d4bbdbf0f2743bf110001bf12d5e8bf14a8f3"
    "bf167917bf18464dbf1a108ebf1bd7cabf1d9bfdbf1f5d1ebf211b23bf22d607bf248dbb"
    "bf26423abf27f37bbf29a176bf2b4c26bf2cf37bbf2e9771bf303800bf31d520bf336ecb"
    "bf3504f3bf369794bf3826a6bf39b224bf3b3a00bf3cbe35bf3e3ebdbf3fbb8fbf4134a7"
    "bf42a9f8bf441b7dbf458930bf46f308bf485903bf49bb13bf4b1934bf4c7360bf4dc98f"
    "bf4f1bbebf5069e0bf51b3f3bf52f9eebf543bcdbf55798bbf56b31dbf57e880bf5919ad"
    "bf5a469fbf5b6f51bf5c93bbbf5db3d7bf5ecfa1bf5fe715bf60fa29bf6208dabf631324"
    "bf641900bf651a6cbf66175ebf670fd4bf6803c9bf68f338bf69de1ebf6ac473bf6ba635"
    "bf6c835ebf6d5bebbf6e2fd9bf6eff21bf6fc9bfbf708fb2bf7150f3bf720d82bf72c557"
    "bf737870bf7426cbbf74d063bf757536bf76153fbf76b07cbf7746eabf77d886bf78654d"
    "bf78ed3cbf797051bf79ee89bf7a67e2bf7adc59bf7b4bebbf7bb698bf7c1c5cbf7c7d37"
    "bf7cd925bf7d3025bf7d8235bf7dcf54bf7e1781bf7e5ababf7e98fdbf7ed249bf7f069d"
    "bf7f35fabf7f605cbf7f85c3bf7fa62fbf7fc1a0bf7fd814bf7fe98bbf7ff605bf7ffd81")

_SIN_05 = (
    "000000003c0ef9be3c8ef8593cd6710b3d0ef2c63d32aa3e3d565e3b3d7a0e093d8edc7b"
    "3da0af2a3db27eb53dc44ac73dd613053de7d7163df996a33e05a8a93e0e83653e175b59"
    "3e20305c3e29023d3e31d0d43e3a9bf33e43636f3e4c271b3e54e6ce3e5da2593e665992"
    "3e6f0c4d3e77ba603e8031cf3e8483ee3e88d3783e8d20573e916a763e95b1be3e99f61c"
    "3e9e377a3ea275c13ea6b0df3eaae8bc3eaf1d433eb34e623eb77c013ebba60c3ebfcc70"
    "3ec3ef163ec80de93ecc28d73ed03fc93ed452ac3ed8616c3edc6bf33ee0722f3ee4740a"
    "3ee871713eec6a503ef05e943ef44e273ef838f73efc1ef13f0000003f01ee093f03d989"
    "3f05c2773f07a8ca3f098c783f0b6d773f0d4bbe3f0f27443f1100003f12d5e83f14a8f3"
    "3f1679183f18464e3f1a108c3f1bd7ca3f1d9bfe3f1f5d1f3f211b243f22d6053f248dba"
    "3f26423a3f27f37c3f29a1783f2b4c253f2cf37b3f2e97723f3038013f31d5223f336eca"
    "3f3504f33f3697953f3826a73f39b2223f3b39ff3f3cbe353f3e3ebe3f3fbb903f4134a5"
    "3f42a9f73f441b7d3f4589303f46f3093f4859023f49bb123f4b19343f4c73613f4dc990"
    "3f4f1bbd3f5069e03f51b3f33f52f9ef3f543bce3f55798b3f56b31d3f57e8813f5919ae"
    "3f5a46a03f5b6f513f5c93ba3f5db3d83f5ecfa13f5fe7143f60fa293f6208da3f631324"
    "3f6419013f651a6b3f66175e3f670fd43f6803ca3f68f3393f69de1e3f6ac4733f6ba634"
    "3f6c835e3f6d5bec3f6e2fd93f6eff203f6fc9c03f708fb23f7150f43f720d813f72c557"
    "3f7378713f7426cb3f74d0633f7575363f76153f3f76b07c3f7746ea3f77d8863f78654d"
    "3f78ed3c3f7970513f79ee893f7a67e23f7adc583f7b4beb3f7bb6983f7c1c5c3f7c7d37"
    "3f7cd9253f7d30253f7d82353f7dcf543f7e17813f7e5aba3f7e98fd3f7ed2493f7f069e"
    "3f7f35f93f7f605c3f7f85c33f7fa62f3f7fc1a03f7fd8143f7fe98b3f7ff6053f7ffd81"
    "3f8000003f7ffd813f7ff6053f7fe98b3f7fd8143f7fc1a03f7fa62f3f7f85c33f7f605c"
    "3f7f35f93f7f069e3f7ed2493f7e98fd3f7e5aba3f7e17813f7dcf553f7d82353f7d3025"
    "3f7cd9253f7c7d373f7c1c5c3f7bb6983f7b4beb3f7adc593f7a67e23f79ee893f797051"
    "3f78ed3c3f78654d3f77d8863f7746ea3f76b07d3f76153f3f7575363f74d0633f7426cb"
    "3f7378713f72c5573f720d823f7150f43f708fb23f6fc9bf3f6eff213f6e2fd93f6d5bec"
    "3f6c835f3f6ba6353f6ac4733f69de1e3f68f3393f6803c93f670fd43f66175e3f651a6c"
    "3f6419023f6313243f6208da3f60fa293f5fe7143f5ecfa33f5db3d73f5c93ba3f5b6f51"
    "3f5a46a13f5919ad3f57e8803f56b31d3f55798b3f543bcf3f52f9ee3f51b3f23f5069e0"
    "3f4f1bbd3f4dc9913f4c73603f4b19343f49bb133f4859033f46f30b3f4589303f441b7d"
    "3f42a9f73f4134a63f3fbb913f3e3ebd3f3cbe353f3b39ff3f39b2233f3826a93f369794"
    "3f3504f33f336ecb3f31d5233f3038003f2e97713f2cf37b3f2b4c253f29a1793f27f37b"
    "3f26423a3f248dbb3f22d6073f211b263f1f5d1e3f1d9bfd3f1bd7ca3f1a108e3f184650"
    "3f1679173f14a8f33f12d5e83f1100013f0f27463f0d4bbd3f0b6d773f098c783f07a8cb"
    "3f05c2793f03d9883f01ee093f0000013efc1ef43ef838f53ef44e263ef05e943eec6a52"
    "3ee871743ee474083ee0722e3edc6bf43ed8616e3ed452b03ed03fc73ecc28d63ec80dea"
    "3ec3ef173ebfcc733ebba60a3eb77c003eb34e633eaf1d463eaae8c03ea6b0dd3ea275c1"
    "3e9e377b3e99f61f3e95b1c33e916a743e8d20573e88d37a3e8483f13e8031cc3e77ba5d"
    "3e6f0c4e3e6659963e5da2603e54e6c83e4c271a3e4363703e3a9bf83e31d0dc3e290239"
    "3e20305a3e175b5b3e0e836a3e05a8b13df9969a3de7d7143dd613093dc44ad23db27ec8"
    "3da0af223d8edc7b3d7a0e143d565e533d32aa643d0ef2ba3cd6710c3c8ef8753c0efa2b")

_STORED = {1.0: (_COS_1, _SIN_1), 0.5: (_COS_05, _SIN_05)}


def theta_count(theta_step_deg: float) -> int:
    """Number of theta bins over [0, pi), as ``hough.py:166-167``."""
    return int(np.round(np.pi / float(np.deg2rad(theta_step_deg))))


def _thetas(theta_step_deg: float) -> np.ndarray:
    step = np.float32(np.deg2rad(theta_step_deg))
    return np.arange(theta_count(theta_step_deg), dtype=np.float32) * step


def _decode(hexs: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(hexs), dtype=">u4").astype(
        np.uint32).view(np.float32)


def theta_table(theta_step_deg: float, device=None):
    """(cos, sin), each an (n_theta,) f32 tensor on ``device``: the
    reference's XLA:CPU table for steps of 1.0 and 0.5 degree, the
    f32-rounded float64 table for any other step."""
    stored = _STORED.get(float(theta_step_deg))
    if stored is not None:
        cos_t, sin_t = (_decode(s) for s in stored)
    else:
        th = _thetas(theta_step_deg).astype(np.float64)
        cos_t = np.cos(th).astype(np.float32)
        sin_t = np.sin(th).astype(np.float32)
    return (torch.from_numpy(cos_t.copy()).to(device),
            torch.from_numpy(sin_t.copy()).to(device))
