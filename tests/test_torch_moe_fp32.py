"""The MoE expert kernels in fp32: kernels M, M′, tgmm and N-gmm take fp32
operands to the device check where bf16 and fp32 both run on the card
(``csrc/moe.cu``, ``csrc/moe_f32.cu``), and the fp32 MoE model trains on
either grouped engine as the JAX Trainer does.

* The four wrappers (``moe_fwd_kernel``, ``moe_bwd_kernel``,
  ``tgmm_kernel``, ``gmm_kernel``) on CPU tensors: fp32 reaches the device
  check (``ValueError``, CUDA tensors), fp16 and mixed dtypes raise
  ``TypeError``, and tgmm refuses an ``out_dtype`` other than its
  operands'. The two custom ops (``gavit_tpu_torch::moe_fwd``, ``::gmm``)
  on fake CUDA tensors: fp32 gives fp32 outputs of the launch's shapes,
  fp16 and mixed dtypes raise ``TypeError``.
* A tiny fp32 MoE ViT (depth 2, E 4, k 2, ``moe.impl: grouped``, dropout
  0) through two port ``Trainer`` steps on the fused engine
  (``GAVIT_MOE_FUSED=1``: the plain versions of M, M′ and tgmm on the CPU)
  and the unfused one (``0``: N-gmm's and tgmm's), against two steps of
  the JAX Trainer on the same weights and batches: losses and
  probabilities within 1e-4 each step, and the parameters after the
  second step (the first AdamW update runs at lr 0) within 1e-5 of each
  tensor's largest value plus 1e-6.

The card holds the kernels to these plain versions
(``tests/test_torch_cuda_moe.py``, ``chip_smoke.py``). At most 3 tests a
file (``.claude/skills/verify/SKILL.md``).
"""

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.data import DataLoader as JaxLoader
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.training import Trainer as JaxTrainer
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.ops import gmm as GM
from gavit_tpu_torch.ops import moe_fused as MF
from gavit_tpu_torch.training.trainer import Trainer
from gavit_tpu_torch.utils.convert import flatten_tree, to_flax_tree

from test_torch_moe_model import port_model, tiny_raw
from test_torch_trainer_loop import FloatDataset


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


E, D, F, CAP, TM = 4, 64, 128, 64, 8


def _operands(kind, device="cpu"):
    """The first operand in ``kind``'s dtype (fp32, fp16, or fp32 beside
    bf16 ones for 'mixed'), the others fp32 ('mixed': bf16)."""
    first = torch.float16 if kind == "fp16" else torch.float32
    rest = torch.bfloat16 if kind == "mixed" else first

    def t(*shape, dtype=rest):
        return torch.zeros(*shape, dtype=dtype, device=device)

    return t, first


def _wrapper_call(name, kind):
    t, first = _operands(kind)
    tiles = torch.zeros(CAP // TM, dtype=torch.int32)
    sizes = torch.full((E,), CAP // E, dtype=torch.int32)
    if name == "moe_fwd_kernel":
        return lambda: MF.moe_fwd_kernel(
            t(CAP, D, dtype=first), t(E, D, F), t(E, F), t(E, F, D), t(E, D),
            tiles, TM, 0, (2, 3), 0.0, 0.0, False, sizes)
    if name == "moe_bwd_kernel":
        return lambda: MF.moe_bwd_kernel(
            t(CAP, D, dtype=first), t(CAP, F), t(E, D, F), t(E, F, D), tiles,
            TM, 0, (2, 3), 0.0, 0.0, False, sizes)
    if name == "tgmm_kernel":
        return lambda: GM.tgmm_kernel(t(CAP, D, dtype=first), t(CAP, F),
                                      sizes)
    if name == "tgmm_kernel out_dtype":
        return lambda: GM.tgmm_kernel(t(CAP, D, dtype=first), t(CAP, F),
                                      sizes, torch.bfloat16)
    return lambda: GM.gmm_kernel(t(CAP, D, dtype=first), t(E, D, F), sizes)


def _op_call(name, kind):
    """The custom op on fake CUDA tensors and the shapes it returns."""
    t, first = _operands(kind, "cuda")
    sizes = torch.empty(E, dtype=torch.int32, device="cuda")
    if name == "moe_fwd":
        return (lambda: torch.ops.gavit_tpu_torch.moe_fwd(
            t(CAP, D, dtype=first), t(E, D, F), t(E, F), t(E, F, D), t(E, D),
            sizes, TM, 0, [2, 3], 0.0, 0.0, False), [(CAP, D), (CAP, F)])
    return (lambda: torch.ops.gavit_tpu_torch.gmm(
        t(CAP, D, dtype=first), t(E, D, F), sizes, False), [(CAP, F)])


CASES = ("moe_fwd_kernel", "moe_bwd_kernel", "tgmm_kernel",
         "tgmm_kernel out_dtype", "gmm_kernel", "op moe_fwd", "op gmm")


def _check_case(name, kind):
    if name.startswith("op "):
        with FakeTensorMode():
            call, shapes = _op_call(name[3:], kind)
            if kind != "fp32":
                with pytest.raises(TypeError, match="float32 tensors of one"):
                    call()
                return
            got = call()
        got = list(got) if isinstance(got, tuple) else [got]
        assert [tuple(o.shape) for o in got] == shapes
        assert all(o.dtype == torch.float32 and o.device.type == "cuda"
                   for o in got)
        return
    call = _wrapper_call(name, kind)
    if name.endswith("out_dtype"):
        # fp32 operands and a bf16 output: tgmm writes its operands' dtype
        with pytest.raises(TypeError, match="writes its operands'"
                           if kind == "fp32" else "float32 tensors of one"):
            call()
    elif kind == "fp32":
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    else:
        with pytest.raises(TypeError, match="float32 tensors of one"):
            call()


def test_kernels_take_fp32_and_refuse_other_dtypes():
    """Each wrapper and op (CASES) over fp32, fp16 and mixed dtypes: one
    test, so that the file keeps its 3 tests (the module docstring)."""
    for name in CASES:
        for kind in ("fp32", "fp16", "mixed"):
            try:
                _check_case(name, kind)
            except BaseException as e:
                raise AssertionError(f"{name} on {kind} inputs") from e


BATCH = 8
STEPS = 2


def _raw():
    raw = tiny_raw("grouped", learning_rate=1e-3, seed=3)
    raw["mesh"] = {"data": 1}
    return raw


@pytest.fixture(scope="module")
def jax_steps():
    """Two steps of the JAX Trainer (its grouped engine is the unfused one
    on the CPU) from the port's weights: per step the loss and the
    probabilities, then the model parameters."""
    raw = _raw()
    _, params, _ = port_model(raw)
    data = FloatDataset(BATCH * STEPS, 0)
    jcfg = jax_from_dict(raw)
    loader = JaxLoader(data, BATCH, shuffle=False, num_workers=1,
                       drop_last=True, seed=3)
    trainer = JaxTrainer(jax_build_model(jcfg.model, precision="fp32"),
                         params, loader, JaxLoader(data, BATCH,
                                                   num_workers=1), jcfg)
    steps = []
    for i in range(STEPS):
        images = data.images[i * BATCH:(i + 1) * BATCH]
        labels = data.labels[i * BATCH:(i + 1) * BATCH]
        trainer.state, metrics, preds = trainer._train_step(
            trainer.state, trainer.base_rng, images, labels)
        steps.append((float(metrics["loss"]), np.asarray(preds)))
    return data, steps, flatten_tree(jax.tree.map(
        np.asarray, trainer.state.params["model"]))


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "unfused"])
def test_fp32_moe_train_step_matches_jax_trainer(jax_steps, fused,
                                                 monkeypatch):
    monkeypatch.setenv("GAVIT_MOE_FUSED", fused)
    data, want_steps, want_params = jax_steps
    calls = {"M": 0, "N-gmm": 0}

    def counted(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(MF, "moe_fwd_reference",
                        counted("M", MF.moe_fwd_reference))
    monkeypatch.setattr(GM, "gmm_reference",
                        counted("N-gmm", GM.gmm_reference))
    raw = _raw()
    model, _, _ = port_model(raw)
    trainer = Trainer(from_dict(raw), model, data.class_weights, STEPS,
                      device="cpu")
    for i, (want_loss, want_probs) in enumerate(want_steps):
        images = torch.from_numpy(data.images[i * BATCH:(i + 1) * BATCH])
        labels = torch.from_numpy(data.labels[i * BATCH:(i + 1) * BATCH])
        metrics, probs = trainer._step(images, labels)
        assert abs(metrics["loss"].item() - want_loss) <= 1e-4, i
        np.testing.assert_allclose(probs.numpy(), want_probs, atol=1e-4,
                                   rtol=0)
    # both MoE blocks through the engine the gate picks
    assert (calls["M"] > 0) == (fused == "1")
    assert (calls["N-gmm"] > 0) == (fused == "0")
    got = flatten_tree(to_flax_tree(trainer.model))
    assert set(got) == set(want_params)
    for key, w in want_params.items():
        assert np.abs(got[key] - w).max() <= 1e-5 * np.abs(w).max() + 1e-6, \
            key
    assert not np.array_equal(got["blocks_1/moe/fc1_kernel"],
                              flatten_tree(to_flax_tree(port_model(raw)[0]))[
                                  "blocks_1/moe/fc1_kernel"])
