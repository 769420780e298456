"""The port's int8 model against gavit_tpu's on the CPU (its ops and the
bridge: ``tests/test_torch_quant.py``).

* ``export_quant``'s ``w_q`` bit-equal and ``w_scale`` equal to the JAX
  export on the same weights and scales.
* The int8 model (bf16 everywhere but the int8 GEMMs) on the JAX
  ``calibrate_int8`` quant tree, carried over by ``quant_from_flax``,
  against the JAX int8 model: probabilities within 3e-3 (max |dp| 7.3e-4
  measured; bf16 rounds at other places in the two frameworks, and a
  bf16-level shift upstream can move an activation across a rounding
  boundary), with the int8 codes that flip counted at every site from the
  inputs the two models give it (the JAX ones recorded through
  ``flax.linen.intercept_methods``): under 10% (5.4% measured). Then the
  same with each flipped code pinned to the JAX side's: probabilities
  within 1e-6 (0 measured), under 5% of the codes pinned (1.3%), and every
  site's input within 2 codes of the JAX one's (0.81). The port's own
  ``calibrate_int8`` on the same model gives the JAX tree's act scales
  within 1e-2 relative, and the weights ``export_quant`` gives.

At most 3 tests a file: with ``--dist loadfile`` pytest-xdist hands out the
files with the most tests first, so a file of 3 or fewer runs beside
``tests/test_evaluate_mesh.py`` instead of ahead of it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.serving import calibrate_int8 as jax_calibrate_int8
from gavit_tpu.serving import export_quant as jax_export_quant
from gavit_tpu_torch.serving import calibrate_int8, export_quant
from gavit_tpu_torch.utils.convert import (flatten_tree, load_quant_state,
                                           quant_from_flax, quant_sites,
                                           quant_to_flax, to_flax_tree)
from test_torch_quant import (TINY, images, jax_site_inputs, site_codes,
                              tiny_model)

# the int8 model (bf16 but for the int8 GEMMs) against the JAX one on the
# same quant tree: max |dp| 7.3e-4 measured (6.4e-4 and 7.3e-4 on two other
# input seeds). At this size the bf16 model without quantisation is as
# close (5.8e-4), so the pinned comparison below is the one that sees the
# int8 arithmetic
PROB_TOL = 3e-3
# a one-ulp bf16 difference upstream moves a code near the range's top:
# 1291 of 23808 codes (5.4%) flip over all sites of this model, 22% at the
# attention projection, whose input the two attentions round to bf16 at
# other places
FLIP_FRACTION = 0.1
# with each flipped code pinned to the JAX side's, every site's GEMM takes
# the same codes and the probabilities come out equal (0 measured, on three
# input seeds): what is left is arithmetic between sites, whose inputs then
# differ by at most 0.81 codes (units of the act scale; 1.21 unpinned),
# and 306 of 23808 codes (1.3%) still flip at a rounding boundary
PINNED_TOL = 1e-6
PINNED_FLIP_FRACTION = 0.05
CODE_GAP_TOL = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_export_quant_matches_jax():
    model = tiny_model("int8")
    params = to_flax_tree(model)
    rng = np.random.default_rng(5)
    paths = sorted(quant_sites(model))
    scales = {p: {"act_scale": np.float32(rng.uniform(0.01, 0.1))}
              for p in paths}
    jtree = {}
    for p, node in scales.items():
        parent = jtree
        for key in p.split("/"):
            parent = parent.setdefault(key, {})
        parent["act_scale"] = jnp.asarray(node["act_scale"])
    # eagerly, as the JAX Predictor calls it: under jit XLA may turn the
    # scale's division by 127 into a product with its reciprocal (an ulp
    # off)
    want = flatten_tree(jax.tree.map(
        np.asarray, jax_export_quant(params, {"quant": jtree})["quant"]))
    got = flatten_tree(quant_to_flax(export_quant(model, scales)))
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def flatten_quant(quant):
    flat = flatten_tree(jax.tree.map(np.asarray, quant["quant"]))
    out = {}
    for key, val in flat.items():
        site, _, leaf = key.rpartition("/")
        out.setdefault(site, {})[leaf] = val
    return out


@pytest.fixture(scope="module")
def int8_pair():
    """The JAX int8 model calibrated on 4 images with the port's weights,
    and the port's int8 model on the same weights."""
    model = tiny_model("int8")
    params = to_flax_tree(model)
    jmodel = jax_build_model(jax_from_dict(TINY).model, precision="int8")
    calib = images(4, seed=7)
    # jitted (an eager calibration interprets every op: 12 s); both models
    # then run on this one tree
    quant = jax.jit(lambda p, x: jax_calibrate_int8(jmodel, p, x))(
        params, jnp.asarray(calib))
    return model, params, jmodel, quant, calib


def test_int8_model_on_jax_quant_tree(int8_pair):
    model, params, jmodel, quant, _ = int8_pair
    x = images(3, seed=2)
    want, inputs = jax.jit(lambda v, x: jax_site_inputs(
        jmodel, v, x, deterministic=True))({"params": params, **quant},
                                           jnp.asarray(x))
    want = np.asarray(jax.nn.sigmoid(want))
    load_quant_state(model, quant_from_flax(
        jax.tree.map(np.asarray, quant["quant"])))
    scales = {p: n["act_scale"] for p, n in flatten_quant(quant).items()}
    for pin, tol, flip_fraction in ((False, PROB_TOL, FLIP_FRACTION),
                                    (True, PINNED_TOL, PINNED_FLIP_FRACTION)):
        with torch.no_grad(), site_codes(model, inputs, scales,
                                         pin=pin) as counts:
            got = model(torch.from_numpy(x))
        err = np.abs(torch.sigmoid(got).numpy() - want).max()
        flips = sum(f for f, *_ in counts.values())
        total = sum(n for _, n, _ in counts.values())
        print(f"int8 model vs JAX, pinned {pin}: max |dp| {err:.3e}, "
              f"{flips} of {total} int8 codes flipped: {counts}")
        assert len(counts) == len(scales)
        assert err <= tol, (pin, err)
        assert flips <= flip_fraction * total, counts
        assert max(g for *_, g in counts.values()) <= CODE_GAP_TOL, counts


def test_port_calibrate_int8_matches_jax(int8_pair):
    """The act scales within 1e-2 of the JAX calibration's (the dynamic-PTQ
    pass is a bf16 model); the weights quantised as ``export_quant`` does
    (held to the JAX export above)."""
    model, _, _, quant, calib = int8_pair
    mine = calibrate_int8(model, torch.from_numpy(calib))
    want = flatten_quant(quant)
    assert set(mine) == set(want)
    exported = export_quant(model, mine)
    for path, node in want.items():
        for key in ("w_q", "w_scale"):
            assert torch.equal(mine[path][key], exported[path][key])
        np.testing.assert_allclose(mine[path]["act_scale"].numpy(),
                                   node["act_scale"], rtol=1e-2)
