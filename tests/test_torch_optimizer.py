"""Port parity of the training recipe against the JAX package's optax
chain, on the CPU: the warm-up multistep schedule, the decay masks by
parameter name, FREEZE_AT, clipping by value and by global norm, three
updates step for step; and the checkpoint files.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_schedule_matches_jax(method):
    """``WarmupMultiStepLR``, the schedule the update reads as a tensor,
    evaluated from its count at every step through the warm-up and both
    decays: JAX's f32 value within 2 f32 ulps (rtol 2.4e-7); its state
    round trip writes the count in place."""
    from centermask2_tpu.train.optimizer import warmup_multistep_schedule as js
    from centermask2_tpu_torch.train import WarmupMultiStepLR

    j = js(0.02, (5, 9), 0.1, 0.01, 4, method)
    sched = WarmupMultiStepLR(0.02, (5, 9), 0.1, 0.01, 4, method)
    for count in range(12):
        lr = sched.lr()
        assert lr.dtype == torch.float32 and lr.dim() == 0
        np.testing.assert_allclose(float(lr), float(j(count)), rtol=2.4e-7,
                                   err_msg=f"step {count}")
        sched.step()
    count = sched.count
    sched.load_state_dict({"last_epoch": 3, "base_lrs": [0.02]})
    assert sched.count is count and sched.last_epoch == 3
    assert sched.state_dict() == {"last_epoch": 3}


class _Named(torch.nn.Module):
    """A module tree with the port's parameter names of the flagship, for
    the optimizer's masks."""

    NAMES = {
        "backbone.stem_1.conv.weight": (4, 3, 3, 3),
        "backbone.OSA2_1.layer0.conv.weight": (4, 4, 3, 3),
        "backbone.OSA3_1.concat.conv.weight": (6, 4, 1, 1),
        "backbone.OSA3_1.ese.fc.bias": (6,),
        "fpn.fpn_lateral3.weight": (5, 6, 1, 1),
        "fcos_head.cls_tower.conv0.bias": (5,),
        "fcos_head.cls_tower.norm0.gn.weight": (5,),
        "fcos_head.cls_tower.norm0.gn.bias": (5,),
        "fcos_head.scale0.scale": (1,),
        "roi_heads.mask_head.predictor.weight": (3, 5, 1, 1),
    }

    def __init__(self, rng):
        super().__init__()
        for name, shape in self.NAMES.items():
            *mods, leaf = name.split(".")
            m = self
            for part in mods:
                if not hasattr(m, part):
                    m.add_module(part, torch.nn.Module())
                m = getattr(m, part)
            m.register_parameter(leaf, torch.nn.Parameter(
                t(rng.randn(*shape).astype(np.float32))))


def _jax_tree(values):
    """Port name -> array, as the JAX parameter tree (the GroupNorm's
    ``gn.weight`` is flax's ``gn/scale``; the other leaf names do not
    enter the masks), plus one FrozenBN leaf the port keeps as a
    buffer."""
    tree = {}
    for name, v in values.items():
        *mods, leaf = name.split(".")
        if mods[-1] == "gn" and leaf == "weight":
            leaf = "scale"
        node = tree
        for part in mods:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    tree["backbone"]["stem_1"]["norm"] = {
        "frozen_scale": jnp.ones((4,), jnp.float32)}
    return tree


def _jax_leaf(tree, name):
    *mods, leaf = name.split(".")
    if mods[-1] == "gn" and leaf == "weight":
        leaf = "scale"
    for part in mods:
        tree = tree[part]
    return np.asarray(tree[leaf])


@pytest.mark.parametrize("clip", [("value", 0.05), ("norm", 0.5),
                                  ("value", 0.0)])
@pytest.mark.parametrize("freeze_at", [0, 2])
def test_three_steps_match_optax(clip, freeze_at):
    """Three updates of make_optimizer against the JAX optax chain:
    warm-up schedule, momentum with nesterov, decay off for the FCOS
    scale and WEIGHT_DECAY_NORM on the GroupNorm, clipping by value or
    global norm, FREEZE_AT 2 (stem and OSA2 frozen). The JAX package
    counts frozen leaves' gradients in the global norm (the port's frozen
    parameters have none), so they get zero gradients on its side."""
    from centermask2_tpu.train.optimizer import make_optimizer as jmake
    from centermask2_tpu_torch.train import make_optimizer

    rng = np.random.RandomState(9)
    model = _Named(rng)
    init = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    kw = dict(momentum=0.9, weight_decay=1e-2, weight_decay_norm=5e-3,
              nesterov=True, warmup_factor=0.1, warmup_iters=2,
              clip_value=clip[1], clip_type=clip[0], freeze_at=freeze_at)
    opt, sched = make_optimizer(model, 0.5, (2,), **kw)
    jopt = jmake(0.5, (2,), **kw)
    params = _jax_tree(init)
    state = jopt.init(params)
    frozen = {n for n in init if n.startswith(("backbone.stem",
                                               "backbone.OSA2"))} \
        if freeze_at == 2 else set()
    for step in range(3):
        grads = {n: (rng.randn(*v.shape) * 0.3).astype(np.float32)
                 for n, v in init.items()}
        jgrads = _jax_tree({n: np.zeros_like(g) if n in frozen else g
                            for n, g in grads.items()})
        jgrads["backbone"]["stem_1"]["norm"]["frozen_scale"] = \
            jnp.zeros((4,), jnp.float32)
        updates, state = jopt.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = t(grads[n])
        opt.step()
        sched.step()
        for n, p in model.named_parameters():
            want = _jax_leaf(params, n) - init[n]
            got = p.detach().numpy() - init[n]
            # a few f32 ulps of the parameters (schedule in f64 here)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{n} step {step}")
    for n, p in model.named_parameters():
        assert p.requires_grad == (n not in frozen)
        if n in frozen:
            np.testing.assert_array_equal(p.detach().numpy(), init[n])


def test_param_groups_follow_the_jax_masks():
    from centermask2_tpu_torch.train.optimizer import param_groups

    model = _Named(np.random.RandomState(10))
    groups = {g["name"]: (g["weight_decay"], g["params"])
              for g in param_groups(model, 1e-4, 1e-5, 0)}
    names = {id(p): n for n, p in model.named_parameters()}
    got = {k: (wd, sorted(names[id(p)] for p in ps))
           for k, (wd, ps) in groups.items()}
    assert got["norm"] == (1e-5, ["fcos_head.cls_tower.norm0.gn.bias",
                                  "fcos_head.cls_tower.norm0.gn.weight"])
    assert got["none"] == (0.0, ["fcos_head.scale0.scale"])
    assert got["decay"][0] == 1e-4 and len(got["decay"][1]) == 7


def test_checkpoint_roundtrip(tmp_path):
    from centermask2_tpu_torch.checkpoint.torch_io import (
        latest_checkpoint, load_checkpoint, save_checkpoint)

    state = {"model": {"w": torch.arange(6.0)}, "step": 7}
    save_checkpoint(str(tmp_path), state, 7)
    save_checkpoint(str(tmp_path), dict(state, step=3), 3)
    os.makedirs(tmp_path / "step_9")  # no state file: not a checkpoint
    path = latest_checkpoint(str(tmp_path))
    assert path.endswith("step_7")
    back = load_checkpoint(path)
    assert torch.equal(back["model"]["w"], state["model"]["w"])
    assert back["step"] == 7
    assert latest_checkpoint(str(tmp_path / "none")) is None
