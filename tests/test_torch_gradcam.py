"""Grad-CAM, attention capture and rollout on the port against the JAX
package's, fp32 on the CPU, at ``tests/test_gradcam_viz.py``'s tiny size
(img 32, patch 8, D 32, depth 2, 2 heads) and the same with a kNN graph
block after block 0 (k 4, gate 0.5); the weights from the port's
initialiser through ``to_flax_tree``, the JAX side under ``jax.jit``.

* ``capture='tokens'`` and ``'attention'`` within 1e-5 of JAX's (fp32 sums
  in other orders), and the captured logits equal to the plain forward's;
* Grad-CAM's CAMs and probabilities within 1e-4 at ``block_index`` -1
  and 0 (block 0's probe before the graph block at its site, so the
  gradient flows back through the graph block and the second block's
  attention). The head reads the CLS token alone, and no attention
  follows the last block to mix the patch tokens into it (a graph block
  leaves CLS out), so their gradient, and the CAM, is zero there in both
  packages;
* attention rollout, ``head_fusion`` mean and max, within 1e-5;
* ``overlay_cam`` equal to JAX's, ``load_bbox_annotations`` equal on a
  CSV with NIH's column names;
* the route of the fp32 attention backward: A′ up to 416 tokens, K′ up
  to 708, L′ past it; the wrappers' refusals come before any device check.
"""

import jax
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.utils import gradcam as jgc
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops import attention as A
from gavit_tpu_torch.utils import gradcam as tgc
from gavit_tpu_torch.utils.convert import to_flax_tree

GRAPH = {"enabled": True, "num_blocks": 1, "insert_after": [0],
         "adjacency": "knn", "k": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def raw_config(graph: bool) -> dict:
    return {"model": {"name": "custom", "img_size": 32, "patch_size": 8,
                      "embed_dim": 32, "depth": 2, "num_heads": 2,
                      "num_classes": 14, "drop_rate": 0.0,
                      "graph": GRAPH if graph else {"enabled": False}},
            "data": {"image_size": 32}}


class _JittedModel:
    """The JAX model with a jitted ``apply`` (one compile in place of an
    eager interpretation of every op) for the JAX functions that call
    ``model.apply`` themselves."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.apply = jax.jit(model.apply,
                             static_argnames=("deterministic", "capture"))


@pytest.fixture(scope="module", params=[False, True], ids=["vit", "graph"])
def pair(request):
    raw = raw_config(request.param)
    model = init_params(build_model(from_dict(raw).model),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(0.5)
    params = jax.tree.map(np.asarray, to_flax_tree(model))
    jmodel = jax_build_model(jax_from_dict(raw).model, precision="fp32")
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    return model, jmodel, _JittedModel(jmodel), params, x


def test_capture_matches_jax(pair):
    model, _, jitted, params, x = pair
    japply = jitted.apply
    xt = torch.from_numpy(x)
    with torch.no_grad():
        base = model(xt)
        for capture in ("tokens", "attention"):
            logits, got = model(xt, capture=capture)
            jlogits, want = japply({"params": params}, x,
                                   deterministic=True, capture=capture)
            assert len(got) == len(want) == 2
            shape = (2, 17, 32) if capture == "tokens" else (2, 2, 17, 17)
            for g, w in zip(got, want):
                assert g.shape == shape and g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-5, rtol=0)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       atol=1e-5, rtol=0)
            if capture == "tokens":
                assert torch.equal(logits, base)
            else:  # the plain attention, another summation order
                torch.testing.assert_close(logits, base, atol=1e-5, rtol=0)


@pytest.mark.parametrize("block", [-1, 0])
def test_gradcam_matches_jax(pair, block):
    model, jmodel, _, params, x = pair
    jcam = jgc.VisionTransformerGradCAM(jmodel, params, block_index=block)
    tcam = tgc.VisionTransformerGradCAM(model, block_index=block)
    cams, probs = tcam(torch.from_numpy(x), 0)
    jcams, jprobs = jcam(x, 0)
    assert cams.shape == (2, 4, 4) and probs.shape == (2, 14)
    assert cams.min() == 0.0 and cams.max() <= 1.0
    # a map in [0, 1], but for the last block (see the module's note)
    assert (cams.max() > 0.999) == (block == 0)
    np.testing.assert_allclose(cams, jcams, atol=1e-4, rtol=0)
    np.testing.assert_allclose(probs, jprobs, atol=1e-4, rtol=0)
    # the probe hook leaves no gradient on the parameters
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("fusion", ["mean", "max"])
def test_rollout_matches_jax(pair, fusion):
    model, _, jitted, params, x = pair
    maps, logits = tgc.attention_rollout(model, torch.from_numpy(x),
                                         head_fusion=fusion)
    jmaps, jlogits = jgc.attention_rollout(jitted, params, x,
                                           head_fusion=fusion)
    assert maps.shape == (2, 4, 4)
    np.testing.assert_allclose(maps, jmaps, atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits, jlogits, atol=1e-5, rtol=0)


def test_overlay_cam_and_bbox_csv_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (32, 40, 3), np.uint8)
    cam = rng.random((4, 4)).astype(np.float32)
    got = tgc.overlay_cam(img, cam, alpha=0.4)
    assert got.dtype == np.uint8 and np.array_equal(
        got, jgc.overlay_cam(img, cam, alpha=0.4))
    csv_path = tmp_path / "BBox_List_2017.csv"
    csv_path.write_text(
        "Image Index,Finding Label,Bbox [x,y,w,h],,,\n"
        "a.png,Nodule,10,20,30,40,\n"
        "a.png,Mass,1.5,2.5,3,4,\n"
        "b.png,Atelectasis,5,6,7,8,\n"
        "c.png,Nodule,1,1,1,1,\n"
        "c.png,Nodule,2,2,2,2,\n"
        "c.png,Mass,3,3,3,3,\n"
        "c.png,Mass,4,4,4,4,\n\n")
    for kw in ({}, {"min_boxes": 2, "max_boxes": 3}):
        got = tgc.load_bbox_annotations(str(csv_path), **kw)
        assert got == jgc.load_bbox_annotations(str(csv_path), **kw)
    assert set(got) == {"a.png"}
    assert got["a.png"]["bboxes"][0] == (10.0, 20.0, 40.0, 60.0)


def test_fp32_backward_route_takes_a_prime_up_to_416_tokens():
    """fp32 rows take A′ up to 416 tokens, K′ up to 708 (the 384-px
    fine-tune's 577) and L′ past it; A′'s and K′'s wrappers refuse what
    they do not take before the device check and stop at the CPU tensor
    otherwise."""
    f32 = torch.float32
    assert A.attention_route(416, f32) == "A"
    assert A.attention_route(417, f32) == "K"
    assert A.attention_route(577, f32) == "K"
    assert A.attention_route(709, f32) == "L"
    # A′'s own refusal comes before the device check: fp32 rows of 416
    # tokens pass it and stop at the CPU tensor, 417 are K′'s
    for n, err, match in ((416, ValueError, "CUDA tensors"),
                          (417, NotImplementedError, "kernel K′ or L′")):
        qkv = torch.zeros(1, n, 3 * 64)
        with pytest.raises(err, match=match):
            A.qkv_attention_bwd_kernel(qkv, torch.zeros(1, 1, n, 64),
                                       0.125, 1)
    qkv = torch.zeros(1, 225, 3 * 64, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="kernel K′ or L′"):
        A.qkv_attention_bwd_kernel(
            qkv, torch.zeros(1, 1, 225, 64, dtype=torch.bfloat16), 0.125, 1)
    # K′ takes the fp32 rows of 577 tokens up to the device check; past
    # 708 they are L′'s
    for n, err, match in ((577, ValueError, "CUDA tensors"),
                          (709, ValueError, "L/L′")):
        qkv = torch.zeros(1, n, 3 * 64)
        with pytest.raises(err, match=match):
            A.qkv_attention_long_bwd_kernel(qkv, torch.zeros(1, 1, n, 64),
                                            0.125, 1)
