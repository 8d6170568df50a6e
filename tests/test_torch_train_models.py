"""The port's differentiable forward and train step against the reference, on
the CPU.

Each family's reduced config (smollm's dense GQA, deepseek-v2's MoE with MLA
and a dense prefix layer, rwkv6, the jamba hybrid with MoE, the whisper
encoder-decoder, llava's prefix embeddings with its loss over the text tail),
cut to 2 layers (jamba's: attention with a dense FFN, Mamba with MoE),
gets the reference's weights (its jitted ``init`` from ``PRNGKey(0)``, carried
across by ``convert.params_from_jax``); both packages then take the loss and
its gradient in every parameter on one batch: the reference through
``jax.value_and_grad`` of its ``make_loss_fn`` (jitted), the port through
``train_step.value_and_grad`` of its own. 32 positions, so that attention
takes the chunked path (the reduced configs switch at 16); the loss in
chunks of 16.

Tolerances: float32, the loss within 1e-5 and each gradient within a
relative L2 error of 1e-5 (summation order only; measured up to 4.5e-6,
RWKV's time-mix parameters); bfloat16 (smollm), the loss within 2e-3 and
each gradient within 5e-2 (measured up to 1.3e-2: the two frameworks round
bf16 products at different points, and bf16 holds 8 bits).

Also: the recurrences' gradients across two ``TIME_CHUNK``s (each chunk
rematerialised, as the reference's ``_chunked_time_scan``); one whole train
step against the reference's; and the served path unchanged by parameters
that require grad (no ``grad_fn``, no remat, the same outputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build as ref_build
from repro.models import ssm as ref_ssm
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_train_step
from repro_torch import configs
from repro_torch.models import build, ssm
from repro_torch.models.convert import params_from_jax, port_arrays
from repro_torch.train import train_step
from repro_torch.train.optimizer import OptConfig

SEQ, BATCH, LOSS_CHUNK = 32, 2, 16
CASES = [("smollm-360m", "float32", {}), ("deepseek-v2-236b", "float32", {}), ("rwkv6-7b", "float32", {}),
         ("jamba-1.5-large-398b", "float32", {}), ("whisper-large-v3", "float32", {}),
         ("llava-next-mistral-7b", "float32", {}), ("smollm-360m", "bfloat16", {}),
         ("smollm-360m", "float32", {"remat": True})]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 5e-2)}  # (loss, gradient relative L2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops at these small shapes on one thread: the suite runs
    several workers on the host's cores, and torch's intra-op threads in each
    would oversubscribe them (tens of times slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, dtype, **over):
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch).reduced(), compute_dtype=dtype, **over)
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), compute_dtype=dtype, **over)
    ref_model = ref_build(ref_cfg)
    params = jax.jit(ref_model.init)(jax.random.PRNGKey(0))
    model = params_from_jax(build(cfg, device="cpu"), jax.tree_util.tree_map(np.asarray, params))
    return ref_model, params, model


def _batch(cfg, seed=0):
    """Numpy inputs: tokens, llava's prefix embeddings (0.02 x normal) before
    its text, whisper's source frames before 16 decoder tokens."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_decoder:
        return {"enc_embeds": rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (BATCH, 16)).astype(np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ - cfg.n_prefix_embeds)).astype(np.int32)}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = (rng.normal(size=(BATCH, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _masters(model):
    return {name: p.detach() for name, p in model.named_parameters()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch,dtype,over", CASES, ids=[f"{a}-{d}{'-remat' if o else ''}" for a, d, o in CASES])
def test_loss_and_grads_match_reference(arch, dtype, over):
    ref_model, params, model = _pair(arch, dtype, n_layers=2, **over)
    batch = _batch(model.cfg)
    ref_loss_fn = ref_train_step.make_loss_fn(ref_model, ref_train_step.TrainConfig(loss_chunk=LOSS_CHUNK))
    (ref_loss, ref_aux), ref_grads = jax.jit(jax.value_and_grad(ref_loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_fn = train_step.make_loss_fn(model, train_step.TrainConfig(loss_chunk=LOSS_CHUNK))
    (loss, aux), grads = train_step.value_and_grad(loss_fn, _masters(model), batch)
    loss_tol, grad_tol = TOL[dtype]
    assert abs(float(loss) - float(ref_loss)) <= loss_tol
    assert float(aux["tokens"]) == float(ref_aux["tokens"])
    want = port_arrays(model.cfg, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), ref_grads))
    assert want.keys() == grads.keys()
    for name, w in want.items():
        assert grads[name].dtype == torch.float32 and grads[name].shape == w.shape, name
        assert _rel_l2(grads[name].numpy(), w) <= grad_tol, (name, _rel_l2(grads[name].numpy(), w))
    if model.cfg.n_experts:  # the gradient reaches the router and the routed experts through the dispatch
        for name in grads:
            if name.endswith(("ffn.router", "ffn.w_gate", "ffn.w_down")):
                assert float(grads[name].abs().max()) > 0.0, name


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_recurrence_gradients_across_time_chunks(arch):
    """The time mix (RWKV6) or the Mamba mixer alone at 2 x TIME_CHUNK steps,
    where the reference rematerialises each chunk: the gradient of a fixed
    random projection of its output and final state in the mixer's
    parameters and input, within 1e-5 relative L2 (f32)."""
    ref_cfg = ref_configs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    s = 2 * ssm.TIME_CHUNK
    assert s == 2 * ref_ssm.TIME_CHUNK
    rng = np.random.default_rng(3)
    if arch == "rwkv6-7b":
        specs, ref_fn, fn = ssm.rwkv6_specs(cfg), ref_ssm.rwkv6_apply, ssm.rwkv6_apply
    else:
        specs, ref_fn, fn = ssm.mamba_specs(cfg), ref_ssm.mamba_apply, ssm.mamba_apply
    shapes = {k: v.shape for k, v in specs.items()}
    weights = {k: (rng.normal(size=shp) * (0.3 if k in ("bonus_u", "decay_base", "a_log", "dt_bias") else 0.1))
               .astype(np.float32) for k, shp in shapes.items()}
    x = rng.normal(size=(1, s, cfg.d_model)).astype(np.float32)
    out_proj = rng.normal(size=(1, s, cfg.d_model)).astype(np.float32)

    def ref_objective(w, xx):
        out, carry = ref_fn(w, xx, ref_cfg)
        final = carry[0] if arch == "rwkv6-7b" else carry["h"]
        return jnp.sum(out * out_proj) + jnp.sum(final)

    ref_g = jax.jit(jax.grad(ref_objective, argnums=(0, 1)))({k: jnp.asarray(v) for k, v in weights.items()}, jnp.asarray(x))
    w = {k: torch.tensor(v, requires_grad=True) for k, v in weights.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, carry = fn(w, xt, cfg)
    final = carry[0] if arch == "rwkv6-7b" else carry["h"]
    (torch.sum(out * torch.tensor(out_proj)) + torch.sum(final)).backward()
    for name in weights:
        assert _rel_l2(w[name].grad.numpy(), np.asarray(ref_g[0][name])) <= 1e-5, name
    assert _rel_l2(xt.grad.numpy(), np.asarray(ref_g[1])) <= 1e-5


def test_train_step_matches_reference():
    """One whole step (loss, clip, AdamW) from the same weights and batch:
    the metrics within f32 rounding of the reference's; each parameter's
    update (new - old) within a relative L2 error of 1e-4, and every
    element within lr x 1e-2 (AdamW's first step moves a parameter by
    lr x g / (|g| + eps): where |g| is near eps = 1e-8, a rounding of g by
    1e-10 moves it by lr x 1e-2)."""
    ref_model, params, model = _pair("smollm-360m", "float32", n_layers=2)
    kw = dict(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10), loss_chunk=LOSS_CHUNK)
    ref_kw = dict(kw, opt=ref_opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    batch = _batch(model.cfg, seed=1)
    ref_state = ref_opt.adamw_init(params, ref_kw["opt"])
    ref_params, _, ref_m = jax.jit(ref_train_step.make_train_step(ref_model, ref_train_step.TrainConfig(**ref_kw)))(
        params, ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = train_step.TrainConfig(**kw)
    masters = _masters(model)
    old = {k: v.clone() for k, v in masters.items()}
    new, state, m = train_step.make_train_step(model, tcfg)(masters, train_step.opt_mod.adamw_init(masters, tcfg.opt),
                                                            batch)
    for key in ("loss", "grad_norm", "lr", "tokens"):
        np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=1e-5, err_msg=key)
    want = port_arrays(model.cfg, jax.tree_util.tree_map(np.asarray, ref_params))
    for name, w in want.items():
        assert torch.equal(masters[name], old[name]), f"{name}: the step wrote its input"
        got_update, want_update = (new[name] - old[name]).numpy(), w - old[name].numpy()
        assert _rel_l2(got_update, want_update) <= 1e-4, (name, _rel_l2(got_update, want_update))
        np.testing.assert_allclose(new[name].numpy(), w, rtol=0, atol=1e-2 * kw["opt"].lr, err_msg=name)
    assert int(state["step"]) == 1


def test_served_path_unchanged_by_parameters_that_require_grad(monkeypatch):
    """With every parameter requiring grad (and remat on), ``prefill`` and
    ``decode_step`` return tensors without a ``grad_fn``, run no remat, and
    give the outputs of the same model with frozen parameters; a recorded
    ``hidden`` does remat each layer."""
    cfg = dataclasses.replace(configs.get_config("smollm-360m").reduced(), remat=True)
    frozen = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    live = build(cfg, device="cpu")
    live.load_state_dict(frozen.state_dict())
    live.requires_grad_(True)
    calls = []
    right = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda *a, **kw: calls.append(1) or right(*a, **kw))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    outs = []
    for model in (frozen, live):
        logits, cache = model.prefill({"tokens": tokens}, 40)
        step_logits, cache = model.decode_step(cache, tokens[:, :1], 32)
        for t in (logits, step_logits, *cache.values()):
            assert t.grad_fn is None and not t.requires_grad
        outs.append((logits, step_logits, cache))
    assert calls == []
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(outs[0][2][k], outs[1][2][k]) for k in outs[0][2])
    h = live.hidden({"tokens": tokens})
    assert h.grad_fn is not None and len(calls) == cfg.n_layers
    assert torch.equal(h.detach(), frozen.hidden({"tokens": tokens}))
