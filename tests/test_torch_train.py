"""The port's training substrate (``repro_torch.train``) on the CPU: the 14
tests of tests/test_train.py run on the port (loss decreases, grad
accumulation equivalence at the reference's tolerances, checkpoint
atomicity, integrity, gc and async save, elastic restore, resume after a
kill, int8 compression bounded, unbiased and still learning, the data
deterministic and Zipf-skewed), and the port held to the reference:

  * ``ZipfBigramStream.batch`` bit for bit, for several (step, host, hosts);
  * ``lr_schedule``, ``clip_by_global_norm`` and ``adamw_update`` within f32
    rounding (rtol 1e-6 on f32 values; bf16 state within one bf16 rounding,
    2**-8 relative), for f32 and bf16 ``state_dtype``;
  * ``quantize_leaf`` exactly, given the reference's uniforms;
  * a checkpoint written by either package read by the other, f32, bf16 and
    int32 leaves, bit for bit;
  * a resumed run's state equal to an uninterrupted run's, exactly.

Inputs come from numpy seeds; each package gets its own copy of every array.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - CI installs hypothesis; shim elsewhere
    from _hypothesis_fallback import given, settings, strategies as st

from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_compression
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.compression import block_shape, compress_decompress_int8, quantize_leaf
from repro_torch.train.data import DataConfig, ZipfBigramStream
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU ops at these small shapes on one thread: the suite runs
    several workers on the host's cores, and torch's intra-op threads in each
    would oversubscribe them (tens of times slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_model():
    return build(configs.get_config("smollm-360m").reduced(), device="cpu")


def _stream(model, batch=8, seq=32):
    return ZipfBigramStream(DataConfig(model.cfg.vocab_size, seq, batch, seed=7))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ------------------------------------------------- tests/test_train.py, on the port

def test_loss_decreases():
    model = _tiny_model()
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    stream = _stream(model)
    step_fn = make_train_step(model, tcfg)
    params, state = init_train_state(model, tcfg, _gen(0))
    losses = []
    for i in range(60):
        params, state, m = step_fn(params, state, stream.batch(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.5, losses[::10]


def test_grad_accum_equivalence():
    """grad_accum=4 must match a single full-batch step numerically."""
    model = _tiny_model()
    base = TrainConfig(opt=OptConfig(lr=1e-3))
    accum = TrainConfig(opt=OptConfig(lr=1e-3), grad_accum=4)
    batch = _stream(model, batch=8).batch(0)
    params, state = init_train_state(model, base, _gen(1))
    p1, _, m1 = make_train_step(model, base)(params, state, batch)
    p2, _, m2 = make_train_step(model, accum)(params, state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    assert max(float((p1[k].float() - p2[k].float()).abs().max()) for k in p1) < 5e-5


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5, dtype=torch.bfloat16)}}
    ckpt.save(tmp_path, 3, tree)
    step, restored = ckpt.restore(tmp_path, tree)
    assert step == 3
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16 and torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"w": torch.ones((4, 4))}
    ckpt.save(tmp_path, 1, tree, keep=5)
    ckpt.save(tmp_path, 2, {"w": tree["w"] * 2}, keep=5)
    # corrupt the newest checkpoint
    leaf = next((tmp_path / "step_2").glob("*.npy"))
    np.save(leaf, np.zeros((4, 4), np.float32) + 99)
    step, restored = ckpt.restore(tmp_path, tree)
    assert step == 1  # fell back to the older valid checkpoint
    assert torch.equal(restored["w"], torch.ones((4, 4)))


def test_checkpoint_ignores_partial_tmp(tmp_path):
    tree = {"w": torch.ones(3)}
    ckpt.save(tmp_path, 5, tree)
    (tmp_path / "step_9.tmp").mkdir()  # simulated crash mid-save
    step, _ = ckpt.restore(tmp_path, tree)
    assert step == 5


def test_checkpoint_gc_keeps_last(tmp_path):
    tree = {"w": torch.ones(2)}
    for s in range(1, 6):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.available_steps(tmp_path) == [4, 5]


def test_async_saver(tmp_path):
    saver = ckpt.AsyncSaver()
    tree = {"w": torch.arange(8.0)}
    saver.save(tmp_path, 7, tree)
    tree["w"].add_(1.0)  # the snapshot was taken at save(): a later write does not reach the disk
    saver.wait()
    step, restored = ckpt.restore(tmp_path, tree)
    assert step == 7 and torch.equal(restored["w"], torch.arange(8.0))
    assert saver.snapshot_s >= 0.0 and saver.write_s > 0.0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_elastic_restore_onto_another_device_or_dtype(tmp_path, device):
    """The reference restores onto another mesh; the port, until its sharding
    module, onto another device: the leaves land on ``device`` in the
    checkpoint's dtypes, whatever device and dtypes ``like`` has (``like``
    gives the structure only)."""
    state = {"params": {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(8, dtype=torch.bfloat16)},
             "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    ckpt.save(tmp_path, 1, state)
    like = {"params": {"w": torch.empty((8, 8), dtype=torch.bfloat16, device="meta"),
                       "b": torch.empty(8, device="meta")},
            "opt": {"step": torch.empty((), dtype=torch.int64, device="meta")}}
    step, restored = ckpt.restore(tmp_path, like, device=device)
    assert step == 1
    for got, want in zip(ckpt._flatten(restored).values(), ckpt._flatten(state).values()):
        assert got.device.type == device and got.dtype == want.dtype and got.shape == want.shape
        if device == "cpu":
            assert torch.equal(got, want)


def test_trainer_resume_after_kill(tmp_path):
    """Train 30 steps with checkpoints, 'crash', resume — the resumed run
    continues from the checkpoint and reaches the same total step count."""
    model = _tiny_model()
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3))
    stream = _stream(model)
    run_cfg = TrainerConfig(total_steps=30, ckpt_every=10, ckpt_dir=str(tmp_path), log_every=100)
    t1 = Trainer(model, tcfg, run_cfg, stream)
    # first run "crashes" after 20 steps: emulate by limiting total_steps
    t1.cfg.total_steps = 20
    r1 = t1.run()
    assert r1["final_step"] == 20
    assert ckpt.available_steps(tmp_path)  # checkpoints exist
    # resumed run picks up from step 20 (not 0) and finishes to 30
    t2 = Trainer(model, tcfg, TrainerConfig(total_steps=30, ckpt_every=10, ckpt_dir=str(tmp_path), log_every=100),
                 stream)
    r2 = t2.run()
    assert r2["final_step"] == 30
    assert len(r2["history"]) == 10  # only the remaining 10 steps were run


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.floats(1e-4, 1e3))
def test_int8_compression_bounded_error(seed, scale):
    rng = np.random.default_rng(seed)
    g = {"w": torch.tensor(rng.normal(size=(64, 33)) * scale, dtype=torch.float32)}
    out = compress_decompress_int8(g, _gen(seed))
    err = (out["w"] - g["w"]).abs()
    # block max / 127 bounds the quantisation step
    step = float(g["w"].abs().max()) / 127.0
    assert float(err.max()) <= step + 1e-6


def test_int8_compression_unbiased():
    g = {"w": torch.full((256, 64), 0.3)}
    outs = [compress_decompress_int8(g, _gen(i))["w"].numpy() for i in range(200)]
    assert abs(np.mean(outs) - 0.3) < 2e-3  # stochastic rounding is unbiased


def test_compressed_training_still_learns():
    model = _tiny_model()
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5), compress_grads=True)
    stream = _stream(model)
    step_fn = make_train_step(model, tcfg)
    params, state = init_train_state(model, tcfg, _gen(3))
    losses = []
    for i in range(40):
        params, state, m = step_fn(params, state, stream.batch(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


def test_data_deterministic_and_elastic():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8, seed=5)
    s = ZipfBigramStream(cfg)
    a = s.batch(3)["tokens"]
    np.testing.assert_array_equal(a, ZipfBigramStream(cfg).batch(3)["tokens"])  # restart-reproducible
    assert not np.array_equal(a, s.batch(4)["tokens"])  # steps differ


def test_data_is_zipf_skewed():
    cfg = DataConfig(vocab_size=512, seq_len=128, global_batch=16, seed=9)
    counts = np.bincount(ZipfBigramStream(cfg).batch(0)["tokens"].ravel(), minlength=512)
    assert counts[:16].sum() / counts.sum() > 0.15


# --------------------------------------------------------- held to the reference

@pytest.mark.parametrize("step,host_id,num_hosts", [(0, 0, 1), (3, 0, 1), (7, 1, 2), (11, 3, 4), (250, 2, 4)])
def test_batch_bit_equal_to_reference(step, host_id, num_hosts):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=42)
    got = ZipfBigramStream(DataConfig(**kw)).batch(step, host_id, num_hosts)
    want = ref_data.ZipfBigramStream(ref_data.DataConfig(**kw)).batch(step, host_id, num_hosts)
    assert got.keys() == want.keys()
    assert got["tokens"].dtype == want["tokens"].dtype
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(ZipfBigramStream(DataConfig(**kw)).batch(step, host_id, num_hosts)["tokens"],
                                  ref_data.make_stream(**kw).batch(step, host_id, num_hosts)["tokens"])


@pytest.mark.parametrize("warmup,total", [(5, 60), (100, 10_000), (0, 1)])
def test_lr_schedule_matches_reference(warmup, total):
    cfg = OptConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    ref_cfg = ref_opt.OptConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    steps = np.unique(np.concatenate([np.arange(0, 130), [total - 1, total, total + 5, 20_000]])).astype(np.int32)
    got = opt.lr_schedule(torch.tensor(steps), cfg).numpy()
    want = np.asarray(ref_opt.lr_schedule(jnp.asarray(steps), ref_cfg))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(seed, dtype="float32"):
    """A small parameter dict (3 leaves, one ragged), numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4, 2)}}

    def draw(s):
        return {k: draw(v) for k, v in s.items()} if isinstance(s, dict) else rng.normal(size=s).astype(np.float32)

    return draw(shapes)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(0)
    got, got_norm = opt.clip_by_global_norm({k: torch.tensor(v) for k, v in _flat(grads).items()}, max_norm)
    want, want_norm = ref_opt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    for k, w in _flat(want).items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=2e-6, atol=0)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype, param_dtype):
    """Three chained updates from the same params, grads and state: params,
    m, v and lr within f32 rounding (one bf16 rounding where stored in bf16)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype)
    cfg, ref_cfg = OptConfig(**kw), ref_opt.OptConfig(**kw)
    pdt = getattr(torch, param_dtype)
    params = {k: torch.tensor(v).to(pdt) for k, v in _flat(_tree(1)).items()}
    ref_params = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(param_dtype), _tree(1))
    state, ref_state = opt.adamw_init(params, cfg), ref_opt.adamw_init(ref_params, ref_cfg)
    for i in range(3):
        grads = _tree(10 + i)
        params, state, lr = opt.adamw_update({k: torch.tensor(v) for k, v in _flat(grads).items()}, state, params, cfg)
        ref_params, ref_state, ref_lr = ref_opt.adamw_update(jax.tree_util.tree_map(jnp.asarray, grads), ref_state,
                                                             ref_params, ref_cfg)
        np.testing.assert_allclose(float(lr), float(ref_lr), rtol=1e-6)
        assert int(state["step"]) == int(ref_state["step"]) == i + 1
        for name, got_tree, want_tree, dt in (("params", params, ref_params, param_dtype),
                                              ("m", state["m"], ref_state["m"], state_dtype),
                                              ("v", state["v"], ref_state["v"], state_dtype)):
            rtol = 2e-6 if dt == "float32" else 2**-8
            for k, w in _flat(want_tree).items():
                assert got_tree[k].dtype == getattr(torch, dt), (name, k)
                np.testing.assert_allclose(_f32(got_tree[k]), np.asarray(w, np.float32), rtol=rtol, atol=1e-12,
                                           err_msg=f"{name} {k} after update {i + 1}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_exact_given_the_reference_uniforms(dtype):
    """The reference's ``compress_decompress_int8`` with a key, and the port's
    ``quantize_leaf`` on each leaf with the uniforms that key draws there
    (the leaves in jax's order: dict keys sorted): equal bit for bit, ragged
    and all-zero leaves included."""
    rng = np.random.default_rng(5)
    leaves = {"a": rng.normal(size=(64, 33)) * 3.0, "b": rng.normal(size=(300,)) * 1e-3, "c": np.zeros((5, 7))}
    grads = {k: jnp.asarray(v.astype(np.float32)).astype(dtype) for k, v in leaves.items()}
    key = jax.random.PRNGKey(123)
    want = ref_compression.compress_decompress_int8(grads, key)
    keys = jax.random.split(key, len(grads))
    for (name, g), k in zip(sorted(grads.items()), keys):
        u = np.asarray(jax.random.uniform(k, block_shape(g.size)))
        got = quantize_leaf(torch.tensor(leaves[name].astype(np.float32)).to(getattr(torch, dtype)), torch.tensor(u))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_f32(got), np.asarray(want[name], np.float32), err_msg=name)


def _ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(4, 6)).astype(np.float32),
                       "layers": [{"g": rng.normal(size=(5,)).astype(np.float32)}] * 2},
            "opt": {"step": np.int32(9), "m": {"w": rng.normal(size=(4, 6)).astype(np.float32)}}}


def _as_port(tree, dtype):
    def leaf(a):
        t = torch.tensor(a)
        return t.to(getattr(torch, dtype)) if t.is_floating_point() else t
    return jax.tree_util.tree_map(leaf, tree)


def _as_ref(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype) if a.dtype.kind == "f" else jnp.asarray(a),
                                  tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_readable_across_packages(tmp_path, writer, dtype):
    """A checkpoint the one package writes, the other restores, leaf for
    leaf and bit for bit (bf16 through its uint16 byte view); the two write
    the same manifest."""
    tree = _ckpt_tree(0)
    port_tree, ref_tree = _as_port(tree, dtype), _as_ref(tree, dtype)
    (ckpt if writer == "port" else ref_ckpt).save(tmp_path / "a", 4, port_tree if writer == "port" else ref_tree,
                                                  meta={"loss": 1.5})
    step, got = ckpt.restore(tmp_path / "a", port_tree)
    ref_step, want = ref_ckpt.restore(tmp_path / "a", ref_tree)
    assert step == ref_step == 4
    got_leaves, want_leaves = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == 5
    for g, w in zip(got_leaves, want_leaves):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(_f32(g), np.asarray(w, np.float32))
    # both packages write the same manifest for the same tree
    (ref_ckpt if writer == "port" else ckpt).save(tmp_path / "b", 4, ref_tree if writer == "port" else port_tree,
                                                  meta={"loss": 1.5})
    manifests = [json.loads((tmp_path / d / "step_4" / "manifest.json").read_text()) for d in ("a", "b")]
    assert manifests[0] == manifests[1]


def test_resumed_run_equals_uninterrupted(tmp_path):
    """20 steps, a checkpoint, and a new Trainer resuming to 30 end at the
    state of one run of 30 steps, bit for bit (params, m, v, step)."""
    model = _tiny_model()
    tcfg = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=5, total_steps=30))
    stream = _stream(model, batch=4, seq=16)

    def trainer(total, d):
        return Trainer(model, tcfg, TrainerConfig(total_steps=total, ckpt_every=10, ckpt_dir=str(d), log_every=100),
                       stream)

    whole = trainer(30, tmp_path / "whole")
    whole.run(seed=4)
    assert trainer(20, tmp_path / "cut").run(seed=4)["final_step"] == 20
    resumed = trainer(30, tmp_path / "cut")
    out = resumed.run(seed=4)
    assert out["final_step"] == 30 and len(out["history"]) == 10
    assert [h["loss"] for h in out["history"]] == [h["loss"] for h in whole.history[20:]]
    a, b = ckpt._flatten(whole.state), ckpt._flatten(resumed.state)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
