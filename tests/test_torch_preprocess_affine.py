"""The port's RandomAffine (``gavit_tpu_torch/ops/preprocess.py``) against
the JAX package's on the same numpy inputs and draws, on the CPU:
``_affine_one`` against ``jpre.random_affine`` within 1e-6 on the same
sin and cos and within 2e-5 as it is, the whole
affine train preprocess against JAX's pieces run op by op
(``random_affine``, ``color_jitter``, ``normalize`` after the flip, as
``train_preprocess`` calls them) within 1e-5 and against the jitted
``train_preprocess(..., use_affine=True)``, the identity at trivial
parameters, a translation that moves content, the draw stream, and the
``ChestXrayTransforms`` factories.

Two roundings are not the warp's and are held apart:

* the port rounds each angle's sin and cos from float64; XLA's fp32 sin
  and cos are one ulp off that for some angles (3 of 30 seeds of 6
  images), and one ulp of a coordinate moves a value by up to ~8e-6 on
  these images. The JAX side here takes the same rounded sin and cos
  (``rounded_trig``), so the comparison is of the warp itself;
* XLA's jitted ``train_preprocess`` differs from its own pieces run op by
  op by up to ~4e-5 (its fused program rounds otherwise), so the port is
  held to the jitted function within that difference plus 1e-5.

The port's own departure, its fp64-rounded sin and cos, is held against
the unmodified JAX functions too, at fixed limits: the warp within 2e-5
(one ulp of a coordinate moves a value by up to ~8e-6; the seeds are
ones whose fp32 sin or cos is an ulp off), the whole preprocess within
5e-5 of the jitted ``train_preprocess`` (XLA's fused rounding, up to
~4e-5, on top).

The images are radiograph-like: a smooth field plus a few grey levels of
noise (on pure noise, neighbours 255 levels apart, one ulp of a
coordinate moves a value ~100 times as far).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gavit_tpu.data.transforms import ChestXrayTransforms as JaxTransforms
from gavit_tpu.ops import preprocess as jpre
from gavit_tpu_torch.data.transforms import ChestXrayTransforms
from gavit_tpu_torch.ops import preprocess as tpre


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rounded_trig(monkeypatch):
    """The JAX side's ``jnp.sin`` and ``jnp.cos`` rounded from float64,
    as the port computes them, for the length of a test."""
    def rounded(fn):
        def call(a):
            return jax.pure_callback(
                lambda v: fn(np.asarray(v, np.float64)).astype(np.float32),
                jax.ShapeDtypeStruct(jnp.shape(a), jnp.float32), a,
                vmap_method="expand_dims")
        return call

    monkeypatch.setattr(jpre.jnp, "sin", rounded(np.sin))
    monkeypatch.setattr(jpre.jnp, "cos", rounded(np.cos))


def radiographs(b, s, seed):
    """uint8 ``[b, s, s, 3]``: a 6 x 6 grid of random greys resized by
    PIL's BICUBIC, plus 0-3 grey levels of noise, in all three channels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        field = Image.fromarray(rng.integers(0, 256, (6, 6), np.uint8))
        img = (np.asarray(field.resize((s, s), Image.BICUBIC), np.int16)
               + rng.integers(0, 4, (s, s), np.int16))
        out.append(np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None],
                             3, axis=-1))
    return np.stack(out)


def jax_affine_draws(key, b, h, w):
    """The draws ``jpre.random_affine`` makes from ``key``: angle in
    radians, translate [b, 2] as a fraction, scale."""
    ka, kt, ks = jax.random.split(key, 3)
    angle = jax.random.uniform(ka, (b,), minval=-5.0, maxval=5.0) * (
        jnp.pi / 180.0)
    shift = jax.random.uniform(kt, (b, 2), minval=-0.05, maxval=0.05)
    scale = jax.random.uniform(ks, (b,), minval=0.95, maxval=1.05)
    return (np.asarray(angle), np.asarray(shift), np.asarray(scale))


@pytest.mark.parametrize("seed", range(6))
def test_affine_one_matches_jax(seed, rounded_trig):
    b, s = 6, 96
    x = radiographs(b, s, seed).astype(np.float32) / 255.0
    key = jax.random.key(seed)
    want = np.asarray(jpre.random_affine(jnp.asarray(x), key))
    angle, shift, scale = jax_affine_draws(key, b, s, s)
    tx, ty = shift[:, 0] * s, shift[:, 1] * s
    got = tpre._affine_one(*(torch.from_numpy(np.array(a)) for a in
                             (x, angle, tx, ty, scale)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # one image with scalar parameters is the same warp
    one = tpre._affine_one(torch.from_numpy(x[1]), float(angle[1]),
                           float(tx[1]), float(ty[1]), float(scale[1]))
    assert torch.equal(one, got[1])
    # the warp moves content and fills outside the image with zeros
    assert not np.allclose(want, x)
    assert (got.numpy() >= 0).all()


@pytest.mark.parametrize("seed", [3, 14, 17])
def test_affine_one_matches_unpatched_jax(seed):
    """Against ``jpre.random_affine`` as it is: at these seeds XLA's fp32
    sin or cos is an ulp off the port's fp64-rounded one."""
    b, s = 6, 96
    x = radiographs(b, s, seed).astype(np.float32) / 255.0
    key = jax.random.key(seed)
    want = np.asarray(jpre.random_affine(jnp.asarray(x), key))
    angle, shift, scale = jax_affine_draws(key, b, s, s)
    got = tpre._affine_one(*(torch.from_numpy(np.array(a)) for a in
                             (x, angle, shift[:, 0] * s, shift[:, 1] * s,
                              scale)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_affine_identity_when_params_trivial():
    x = torch.from_numpy(radiographs(2, 16, 0).astype(np.float32) / 255.0)
    out = tpre.random_affine(x, torch.Generator().manual_seed(0),
                             degrees=0.0, translate=0.0,
                             scale_range=(1.0, 1.0))
    np.testing.assert_allclose(out.numpy(), x.numpy(), atol=1e-5)


def test_affine_translation_moves_content():
    """A bright pixel under a large translation: its bilinear mass stays in
    the image and lands elsewhere, as the JAX test has it; with the same
    draws the port's warp is the JAX one's."""
    x = np.zeros((1, 16, 16, 3), np.float32)
    x[0, 8, 8, :] = 1.0
    out = tpre.random_affine(torch.from_numpy(x),
                             torch.Generator().manual_seed(3), degrees=0.0,
                             translate=0.4, scale_range=(1.0, 1.0)).numpy()
    assert out.sum() > 0 and not np.allclose(out, x)
    want = np.asarray(jpre._affine_one(jnp.asarray(x[0]), 0.0, 3.0, -2.5,
                                       1.0))
    got = tpre._affine_one(torch.from_numpy(x[0]), 0.0, 3.0, -2.5, 1.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert got[5, 11].sum() > 0 and got[8, 8].sum() == 0


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_affine_train_preprocess_matches_jax(seed, rounded_trig):
    """``train_preprocess(images, key, use_affine=True)``: flip, affine,
    jitter, normalise, with the draws re-derived from the key as that
    function splits it, against ``train_preprocess_with`` on them."""
    b, s = 6, 64
    imgs = radiographs(b, s, seed)
    key = jax.random.key(seed)
    kf, ka, kj = jax.random.split(key, 3)
    flip = jax.random.bernoulli(kf, 0.5, (b, 1, 1, 1))
    x = jpre.to_float(jnp.asarray(imgs))
    x = jnp.where(flip, x[:, :, ::-1, :], x)
    pieces = np.asarray(jpre.normalize(jpre.color_jitter(
        jpre.random_affine(x, ka), kj)))
    jitted = np.asarray(jpre.train_preprocess(jnp.asarray(imgs), key,
                                              use_affine=True))
    kb, kc = jax.random.split(kj)
    bf = jax.random.uniform(kb, (b, 1, 1, 1), minval=0.8, maxval=1.2)
    cf = jax.random.uniform(kc, (b, 1, 1, 1), minval=0.8, maxval=1.2)
    angle, shift, scale = jax_affine_draws(ka, b, s, s)
    draws = [np.array(a).ravel() for a in (flip, bf, cf)]
    got = tpre.train_preprocess_with(
        torch.from_numpy(imgs), *(torch.from_numpy(np.array(a)) for a in
                                  (*draws, angle, shift, scale)))
    np.testing.assert_allclose(got.numpy(), pieces, atol=1e-5, rtol=0)
    xla_fusion = float(np.abs(jitted - pieces).max())
    assert float(np.abs(got.numpy() - jitted).max()) <= xla_fusion + 1e-5
    assert np.asarray(flip).any() and not np.asarray(flip).all()


@pytest.mark.parametrize("seed", [14, 19, 25])
def test_affine_train_preprocess_matches_unpatched_jitted_jax(seed):
    """The jitted ``train_preprocess(images, key, use_affine=True)`` as it
    is, sin, cos and fusion included, against ``train_preprocess_with``
    on the draws re-derived from the key."""
    b, s = 6, 64
    imgs = radiographs(b, s, seed)
    key = jax.random.key(seed)
    kf, ka, kj = jax.random.split(key, 3)
    flip = jax.random.bernoulli(kf, 0.5, (b, 1, 1, 1))
    jitted = np.asarray(jpre.train_preprocess(jnp.asarray(imgs), key,
                                              use_affine=True))
    kb, kc = jax.random.split(kj)
    bf = jax.random.uniform(kb, (b, 1, 1, 1), minval=0.8, maxval=1.2)
    cf = jax.random.uniform(kc, (b, 1, 1, 1), minval=0.8, maxval=1.2)
    angle, shift, scale = jax_affine_draws(ka, b, s, s)
    draws = [np.array(a).ravel() for a in (flip, bf, cf)]
    got = tpre.train_preprocess_with(
        torch.from_numpy(imgs), *(torch.from_numpy(np.array(a)) for a in
                                  (*draws, angle, shift, scale)))
    np.testing.assert_allclose(got.numpy(), jitted, atol=5e-5, rtol=0)


def test_affine_draws_follow_the_jitter_draws():
    """With ``use_affine`` the flip and jitter draw first, as without it, so
    a run without the affine keeps its draws; the affine's come after,
    within their ranges."""
    imgs = torch.from_numpy(radiographs(4, 32, 0))
    plain = tpre.train_preprocess(imgs, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    flip = torch.rand(4, generator=gen) < 0.5
    bright, contrast = (0.8 + 0.4 * torch.rand(4, generator=gen)
                        for _ in range(2))
    assert torch.equal(plain, tpre.train_preprocess_with(imgs, flip, bright,
                                                         contrast))
    angle, shift, scale = tpre.affine_draws(4, gen, "cpu")
    assert (angle.abs() <= 5 * np.pi / 180).all()
    assert (shift.abs() <= 0.05).all() and shift.shape == (4, 2)
    assert ((scale >= 0.95) & (scale <= 1.05)).all()
    warped = tpre.train_preprocess(imgs, torch.Generator().manual_seed(5),
                                   use_affine=True)
    assert torch.equal(warped, tpre.train_preprocess_with(
        imgs, flip, bright, contrast, angle, shift, scale))


def test_transform_factories():
    """The factories: train (affine) and simple train as
    ``train_preprocess`` with and without it, val as ``val_preprocess``
    and equal to the JAX val transform."""
    imgs = radiographs(2, 32, 3)
    t = torch.from_numpy(imgs)
    for factory, affine in (
            (ChestXrayTransforms.get_train_transforms, True),
            (ChestXrayTransforms.get_train_transforms_simple, False)):
        fn = factory({"data": {}})
        got = fn(t, torch.Generator().manual_seed(1))
        assert torch.equal(got, tpre.train_preprocess(
            t, torch.Generator().manual_seed(1), use_affine=affine))
    val = ChestXrayTransforms.get_val_transforms()(t)
    want = np.asarray(JaxTransforms.get_val_transforms()(jnp.asarray(imgs)))
    np.testing.assert_allclose(val.numpy(), want, atol=1e-6, rtol=0)
