"""Options the port used to read and drop, now taken or reported:

* ``model.attn_drop_rate``: in training with a rate above 0 the port's
  ``Attention`` leaves the kernels for ``attention_reference`` in tensor
  ops, which drops the fp32 probabilities. Held against the JAX package's
  ``attention_reference`` on the same keep mask, drawn in the test with
  ``jax.random.bernoulli`` as that function draws it, within 1e-5 in fp32
  (forward and the gradients of q, k, v); the model's mask is Philox's at
  a site past every other, the same under ``model.remat``; at rate 0 the
  path is the one it was, bit for bit, through the same op.
* ``model.pretrained_path``: ``scripts/train_torch.py`` loads the file
  where it exists (a reference-layout checkpoint: the weights become the
  file's, the head keeps its init), exits nonzero naming the file where it
  cannot be read (no training from random weights in its place), and
  trains as before where it does not exist.
* ``config.unused_note``: ``training.log_grad_norm`` and
  ``training.steps_per_call``, once read and dropped, are taken by the
  trainer now and no longer named; the note names ``data.loader`` and
  ``training.prng_impl`` set away from their defaults, and
  ``scripts/train_torch.py`` logs that line.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.ops.attention import attention_reference as jax_reference
from gavit_tpu_torch.config import from_dict, unused_note
from gavit_tpu_torch.models import layers
from gavit_tpu_torch.models.vit import (attention_probs_sites, build_model,
                                        dropout_sites, init_params)
from gavit_tpu_torch.ops import philox
from gavit_tpu_torch.ops.attention import attention_reference


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
B, H, N, HD = 2, 2, 9, 8
RATE = 0.25


def test_attention_dropout_matches_jax_on_the_same_mask():
    rng = np.random.default_rng(0)
    q, k, v, r = (rng.standard_normal((B, H, N, HD)).astype(np.float32)
                  for _ in range(4))
    drng = jax.random.key(3)
    keep = np.array(jax.random.bernoulli(drng, 1.0 - RATE, (B, H, N, N)))
    assert 0 < keep.mean() < 1

    def loss(q, k, v):
        out = jax_reference(q, k, v, HD ** -0.5, dropout_rate=RATE,
                            dropout_rng=drng)
        return jnp.sum(out * r), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention_reference(*leaves, HD ** -0.5, RATE,
                              torch.from_numpy(keep))
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    for t, g in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=0)


def _attention(rate, seed=0):
    g = torch.Generator().manual_seed(seed)
    mod = layers.Attention(16, H, attn_drop=rate, proj_drop=0.1, site=4,
                           attn_site=40)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return mod.train()


def test_rate_zero_path_is_unchanged(monkeypatch):
    """At rate 0 (and in eval mode at any rate) Attention runs the fused op,
    as before the option existed: the same op called once per forward, the
    output bit for bit the one that op gives, no mask drawn."""
    x = torch.randn(B, N, 16, generator=torch.Generator().manual_seed(1))
    seed = philox.step_seed(0, 2)
    calls = []
    fused = layers.fused_qkv_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return fused(*a, **kw)

    monkeypatch.setattr(layers, "fused_qkv_attention", spy)
    masks, keep_mask = [], philox.keep_mask
    monkeypatch.setattr(philox, "keep_mask", lambda shape, *a, **kw: (
        masks.append(tuple(shape)) or keep_mask(shape, *a, **kw)))
    for mod in (_attention(0.0), _attention(RATE).eval()):
        out = mod(x, seed)
        qkv = mod.qkv(x).view(B, N, 3, H, 8)
        want = mod.proj_drop(mod.proj(fused(qkv, 8 ** -0.5,
                                            merge_heads=False)), seed)
        assert torch.equal(out, want)
    assert calls == [(B, N, 3, H, 8)] * 2
    # the projection's dropout masks only, none of [B, H, N, N]
    assert masks and (B, H, N, N) not in masks


def test_attention_dropout_in_the_model():
    """Training with attn_drop_rate: the block's probabilities carry the
    Philox mask of (seed, its own site), which model.remat draws again."""
    x = torch.randn(B, N, 16, generator=torch.Generator().manual_seed(2))
    seed = philox.step_seed(0, 5)
    mod = _attention(RATE)
    qkv = mod.qkv(x).view(B, N, 3, H, 8)
    keep = philox.keep_mask((B, H, N, N), seed, 40, RATE)
    want = mod.proj_drop(mod.proj(attention_reference(
        *qkv.permute(2, 0, 3, 1, 4), 8 ** -0.5, RATE, keep)), seed)
    assert torch.equal(mod(x, seed), want)
    assert not torch.equal(mod(x, philox.step_seed(0, 6)), want)
    with pytest.raises(ValueError, match="seed"):
        mod(x)

    sites = dropout_sites(12, 2)
    old = [s for v in sites.values()
           for s in (v if isinstance(v, tuple) else (v,))]
    new = attention_probs_sites(12, 2)
    assert len(set(new)) == 12 and min(new) > max(old)

    raw = {"model": {"name": "custom", "img_size": 16, "patch_size": 8,
                     "embed_dim": 16, "depth": 2, "num_heads": 2,
                     "num_classes": 14, "drop_rate": 0.1,
                     "attn_drop_rate": RATE, "graph": {"enabled": False}},
           "training": {"precision": "fp32"}}
    img = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(3))
    grads = {}
    for remat in (False, True):
        raw["model"]["remat"] = remat
        model = init_params(build_model(from_dict(raw).model),
                            torch.Generator().manual_seed(0)).train()
        assert model.blocks[1].attn.attn_site == 1 + 3 * 2 + 0 + 1
        loss = model(img, seed=seed).square().sum()
        loss.backward()
        grads[remat] = (loss.detach(), [p.grad for p in model.parameters()])
    assert torch.equal(grads[True][0], grads[False][0])
    assert all(torch.equal(a, b) for a, b in zip(grads[True][1],
                                                  grads[False][1]))


def _train_main():
    sys.path.insert(0, str(ROOT / "scripts"))
    import train_torch

    return train_torch.main


TINY = ["--synthetic", "--steps", "1", "--device", "cpu", "--set",
        "model.img_size=16", "--set", "model.patch_size=8", "--set",
        "model.embed_dim=16", "--set", "model.depth=1", "--set",
        "model.num_heads=2", "--set", "data.image_size=16", "--set",
        "data.batch_size=2", "--set", "data.synthetic_size=4"]


def test_train_cli_refuses_an_existing_pretrained_path(tmp_path):
    """An existing file that is no checkpoint is refused by name; a
    reference-layout checkpoint is loaded; an absent file is ignored."""
    from tests.torch_ref import TorchRefViT, reference_state_dict

    ckpt = tmp_path / "vit-b_CXR_0.5M_mae.pth"
    ckpt.write_bytes(b"weights")
    with pytest.raises(SystemExit) as exc:
        _train_main()([*TINY, "--set", f"model.pretrained_path={ckpt}"])
    assert exc.value.code not in (0, None)
    assert "pretrained_path" in str(exc.value.code)
    assert str(ckpt) in str(exc.value.code)

    torch.manual_seed(0)
    ref = TorchRefViT(img_size=16, patch_size=8, embed_dim=16, depth=1,
                      num_heads=2, num_classes=14)
    sd = reference_state_dict(ref)
    torch.save({"model": sd}, ckpt)
    fresh = _train_main()([*TINY, "--steps", "0", "--set",
                           "model.pretrained_path="])
    loaded = _train_main()([*TINY, "--steps", "0", "--set",
                            f"model.pretrained_path={ckpt}"])
    assert torch.equal(loaded.model.pos_embed, sd["pos_embed"])
    assert torch.equal(loaded.model.blocks[0].mlp.fc1.weight,
                       sd["blocks.0.mlp.fc1.weight"])
    assert torch.equal(loaded.model.head.weight, fresh.model.head.weight)
    # an absent file changes nothing: one step, as before
    trainer = _train_main()(
        [*TINY, "--set", f"model.pretrained_path={tmp_path / 'absent.pth'}"])
    assert trainer.step == 1


@pytest.mark.parametrize("training,named", [
    ({}, []),
    ({"log_grad_norm": True}, []),
    ({"steps_per_call": 4}, []),
    ({"log_grad_norm": True, "steps_per_call": 2}, []),
    ({"log_grad_norm": False, "steps_per_call": 1}, []),
    ({"prng_impl": "threefry2x32"}, ["training.prng_impl=threefry2x32"]),
    ({"prng_impl": "rbg", "data_loader": "grain"}, []),
], ids=["defaults", "grad_norm", "steps_per_call", "both", "defaults_set",
        "prng_impl", "loader"])
def test_unused_note_names_each_field_set(training, named):
    """log_grad_norm, steps_per_call and data.loader (grain: the
    checkpointable loader) are taken now: never named."""
    training = dict(training)
    data = {"loader": training.pop("data_loader")} \
        if "data_loader" in training else {}
    note = unused_note(from_dict({"training": training, "data": data}))
    if not named:
        assert note is None
        return
    assert "read and not used" in note
    for field in named:
        assert field in note
    for other in {"data.loader", "training.prng_impl",
                  "training.log_grad_norm", "training.steps_per_call"} - {
            f.split("=")[0] for f in named}:
        assert other not in note


def test_train_cli_logs_the_unused_note(caplog):
    """The CLI takes log_grad_norm (the step line shows the norm),
    steps_per_call and data.loader without naming them, and logs the note
    for a field the port does not use."""
    caplog.set_level("INFO")
    trainer = _train_main()(
        [*TINY, "--set", "training.log_grad_norm=true", "--set",
         "training.steps_per_call=2", "--set", "data.loader=grain"])
    assert trainer.step == 1  # --steps: one step a call, as before
    assert not [r for r in caplog.records
                if "read and not used" in r.getMessage()]
    assert [r for r in caplog.records if "grad norm" in r.getMessage()]
    caplog.clear()
    _train_main()([*TINY, "--set", "training.prng_impl=threefry2x32"])
    lines = [r.getMessage() for r in caplog.records
             if "read and not used" in r.getMessage()]
    assert len(lines) == 1 and "training.prng_impl=threefry2x32" in lines[0]
    caplog.clear()
    _train_main()(TINY)
    assert not [r for r in caplog.records
                if "read and not used" in r.getMessage()]
