"""The port's training (``outline_rag_tpu_torch/models/train.py``) against the
JAX package's (``outline_rag_tpu/models/train.py``) on the CPU in f32.

The same seeded weights (``init_*_params`` with a fixed key, carried over
with ``*_from_jax``) and the same numpy batches go through JAX's jitted step
and the port's step, three steps each at lr 1e-4: every step's loss within
rtol 1e-5 and every updated parameter within 1e-6 absolute (read back with
``encoder_to_jax`` / ``reranker_to_jax``) but a share of at most 1e-4 of
the elements, whose gradient is at the level of f32 rounding and which
Adam's normalisation turns into a step of either sign (``NOISE_SHARE``);
the optimizer alone, fed the same gradients, agrees to 1e-6 everywhere. The JAX decoder's forward needs
stacked layers, so its LM step here differentiates the per-layer list
through ``stack_decoder_params`` inside the loss: the list is the tree on
which JAX's decay mask is right (on the stacked tree it decays the RMSNorm
scales, a reference defect the port does not carry; the last mask test
shows it). Then the port's own versions of JAX's behaviour tests, the
checkpoint round trip, remat, and the two repairs this training needs: the
flash route refuses autograd, and the decoder's ring path runs backward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from outline_rag_tpu.models import decoder as jdec
from outline_rag_tpu.models import encoder as je
from outline_rag_tpu.models import train as jt
from outline_rag_tpu.models.reranker import init_reranker_params
from outline_rag_tpu_torch.models import convert
from outline_rag_tpu_torch.models import decoder as tdec
from outline_rag_tpu_torch.models import train as tt
from outline_rag_tpu_torch.models.encoder import EncoderConfig, pooled_embeddings
from outline_rag_tpu_torch.ops.attention import flash_attention, flash_attention_plain

LR, STEPS = 1e-4, 3
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6
# Adam steps g / (|g| + eps): where a gradient element sits at the level of
# f32 rounding (analytically zero, as an attention key bias under the
# softmax or the classifier's output bias under the group softmax, or zero
# by chance), the two packages' rounding decides the sign of a step of up to
# ~lr. Such elements are rare: every element but a NOISE_SHARE of them within
# PARAM_ATOL, and all within the most two runs can drift apart.
NOISE_SHARE, NOISE_ATOL = 1e-4, 2 * STEPS * LR
GROUP = 4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_close(got, want):
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    diff = np.concatenate([np.abs(np.asarray(g) - np.asarray(w)).ravel() for g, w in zip(gl, wl)])
    assert (diff > PARAM_ATOL).mean() <= NOISE_SHARE, np.sort(diff)[-10:]
    assert diff.max() <= NOISE_ATOL, diff.max()


def unstack(tree, n):
    layers = tree["layers"]
    out = dict(tree)
    out["layers"] = [jax.tree_util.tree_map(lambda x, i=i: x[i], layers) for i in range(n)]
    return out


def dec_to_np(params):
    return jax.tree_util.tree_map(lambda t: t.detach().numpy().copy(), params)


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def padded(rng, b, s, vocab):
    """Token ids and masks with a few rows padded at the end (XLM-R pad 1)."""
    ids = rng.integers(3, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row, n in zip(range(1, b, 3), rng.integers(s // 2, s, size=b)):
        mask[row, n:] = 0
        ids[row, n:] = 1
    return ids, mask


def contrastive_batch(seed, b=8, s=16, vocab=1024):
    rng = np.random.default_rng(seed)
    q_ids, q_mask = padded(rng, b, s, vocab)
    p_ids, p_mask = padded(rng, b, s, vocab)
    return {"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask}


def rerank_batch(seed, b=4, s=24, vocab=1024):
    ids, mask = padded(np.random.default_rng(seed), b * GROUP, s, vocab)
    return {"pair_ids": ids, "pair_mask": mask}


def lm_batch(seed, b=4, s=32, vocab=256):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.int32)
    mask[1, 20:] = 0
    mask[3, 9:] = 0
    return {"tokens": rng.integers(0, vocab, size=(b, s)).astype(np.int32), "mask": mask}


def run_jax(step, params, opt, batch):
    state = jt.init_train_state(params, opt)
    step = jax.jit(step)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, np_tree(state.params)


def run_port(step, params, batch):
    state = tt.init_train_state(params, tt.make_optimizer(lr=LR))
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, to_torch(batch))
        losses.append(float(metrics["loss"]))
    assert state.step == STEPS and state.opt_state.count == STEPS
    return losses


def jax_lm_list_step(cfg, opt):
    """``make_lm_train_step``'s body for the per-layer list: the list is
    stacked inside the loss, so the gradient and the decay mask are the
    list's."""

    def step(state, batch):
        def loss_fn(p):
            return jt.lm_loss(jdec.stack_decoder_params(p), batch["tokens"], batch["mask"], cfg)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return jt.TrainState(params=params, opt_state=opt_state, step=state.step + 1), {"loss": loss}

    return step


def fuse_list(params):
    """The JAX fused names on the per-layer list (``fuse_decoder_params``
    stacks first)."""
    out = dict(params)
    out["layers"] = [
        {"ln1": l["ln1"], "ln2": l["ln2"], "wo": l["wo"], "wd": l["wd"],
         "wqkv": jnp.concatenate([l["wq"], l["wk"], l["wv"]], axis=-1),
         "wgu": jnp.concatenate([l["wg"], l["wu"]], axis=-1)}
        for l in params["layers"]
    ]
    return out


# --------------------------------------------------------------------------
# three steps against JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
def test_contrastive_steps_match_jax(remat):
    """List form (the python loop), and remat against JAX's stacked remat
    (``test_remat_scan_train_step_matches``'s setup)."""
    jcfg = je.EncoderConfig.tiny()
    params = je.init_encoder_params(jax.random.key(3), jcfg)
    batch = contrastive_batch(2)
    opt = jt.make_optimizer(lr=LR)
    jparams = je.stack_layer_params(params) if remat else params
    want_losses, want = run_jax(jt.make_train_step(jcfg, opt, remat=remat), jparams, opt, batch)
    if remat:
        want = unstack(want, jcfg.layers)

    cfg = convert.config_from_jax(jcfg)
    enc = convert.encoder_from_jax(np_tree(params), cfg, device="cpu")
    losses = run_port(tt.make_train_step(cfg, tt.make_optimizer(lr=LR), remat=remat), enc, batch)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert_trees_close(convert.encoder_to_jax(enc), want)


def test_deeper_contrastive_run_follows_jax():
    """Twelve layers of 128 for six steps at lr 1e-4 (JAX's scanned form):
    the port's loss curve stays on JAX's within rtol 1e-5 at every step."""
    jcfg = dataclasses.replace(je.EncoderConfig.tiny(), layers=12, hidden=128, heads=2,
                               intermediate=512)
    params = je.init_encoder_params(jax.random.key(4), jcfg)
    batch = contrastive_batch(3, b=16, s=24)
    opt = jt.make_optimizer(lr=LR)
    state = jt.init_train_state(je.stack_layer_params(params), opt)  # scanned: one traced layer
    step = jax.jit(jt.make_train_step(jcfg, opt))
    want = []
    for _ in range(6):
        state, metrics = step(state, batch)
        want.append(float(metrics["loss"]))
    enc = convert.encoder_from_jax(np_tree(params), convert.config_from_jax(jcfg), device="cpu")
    topt = tt.make_optimizer(lr=LR)
    tstate, tstep = tt.init_train_state(enc, topt), tt.make_train_step(enc.cfg, topt)
    got = [float(tstep(tstate, to_torch(batch))[1]["loss"]) for _ in range(6)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < 0.9 * got[0]


def test_reranker_steps_match_jax():
    """``group=4``, as ``tests/test_train.py``'s cross-encoder test."""
    jcfg = je.EncoderConfig.tiny()
    params = init_reranker_params(jax.random.key(0), jcfg)
    batch = rerank_batch(1)
    opt = jt.make_optimizer(lr=LR)
    want_losses, want = run_jax(jt.make_reranker_train_step(jcfg, opt, GROUP), params, opt, batch)

    cfg = convert.config_from_jax(jcfg)
    rr = convert.reranker_from_jax(np_tree(params), cfg, device="cpu")
    losses = run_port(tt.make_reranker_train_step(cfg, tt.make_optimizer(lr=LR), GROUP), rr, batch)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert_trees_close(convert.reranker_to_jax(rr), want)


@pytest.mark.parametrize("fused", [False, True])
def test_lm_steps_match_jax(fused):
    jcfg = jdec.DecoderConfig.tiny()
    params = jdec.init_decoder_params(jax.random.key(0), jcfg)
    if fused:
        params = fuse_list(params)
    batch = lm_batch(4)
    opt = jt.make_optimizer(lr=LR)
    want_losses, want = run_jax(jax_lm_list_step(jcfg, opt), params, opt, batch)

    cfg = convert.decoder_config_from_jax(jcfg)
    tparams = convert.decoder_from_jax(np_tree(params), cfg, device="cpu")
    losses = run_port(tt.make_lm_train_step(cfg, tt.make_optimizer(lr=LR)), tparams, batch)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert_trees_close(dec_to_np(tparams), want)


def test_adamw_update_equals_optax_on_the_same_gradients():
    """The optimizer alone, on the gradients JAX computed: fed the same three
    gradients, optax's ``adamw`` and the port's update agree to 1e-6 on
    every element (the noise above comes from the gradients, not the
    update)."""
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), attn_bias=True)
    params = np_tree(jdec.init_decoder_params(jax.random.key(1), jcfg))
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(np.shape(x)) * 10.0 ** rng.integers(-9, -2)).astype(np.float32),
        params) for _ in range(STEPS)]
    opt = jt.make_optimizer(lr=LR)
    jp, js = params, opt.init(params)
    for g in grads:
        updates, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, updates)

    cfg = convert.decoder_config_from_jax(jcfg)
    tp = convert.decoder_from_jax(params, cfg, device="cpu")
    topt = tt.make_optimizer(lr=LR)
    state = tt.init_train_state(tp, topt)
    for g in grads:
        topt.update(tt.named_params(convert.decoder_from_jax(g, cfg, device="cpu")), state.opt_state, tp)
    for got, want in zip(jax.tree_util.tree_leaves(dec_to_np(tp)), jax.tree_util.tree_leaves(np_tree(jp))):
        np.testing.assert_allclose(got, want, rtol=0, atol=PARAM_ATOL)


# --------------------------------------------------------------------------
# the decay mask
# --------------------------------------------------------------------------


def nonzero_like(tree, seed):
    """Every leaf away from zero, so that a decayed leaf always moves."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32), np_tree(tree)
    )


def jax_decayed(params):
    """Which leaves JAX's optimizer decays: one update on zero gradients
    moves exactly those."""
    opt = jt.make_optimizer(lr=0.1, weight_decay=0.5)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    updates, _ = opt.update(zeros, opt.init(params), params)
    return jax.tree_util.tree_map(lambda u: bool(np.any(np.asarray(u) != 0)), updates)


def port_decayed(model, to_np_tree):
    """The same for the port's optimizer, read back in the JAX layout."""
    state = tt.init_train_state(model, tt.make_optimizer(lr=0.1, weight_decay=0.5))
    before = to_np_tree(model)
    zeros = {n: torch.zeros_like(p) for n, p in tt.named_params(model).items()}
    tt.make_optimizer(lr=0.1, weight_decay=0.5).update(zeros, state.opt_state, model)
    return jax.tree_util.tree_map(lambda a, b: bool(np.any(a != b)), to_np_tree(model), before)


def _mask_case(name):
    if name == "encoder":
        jcfg = je.EncoderConfig.tiny()
        params = nonzero_like(je.init_encoder_params(jax.random.key(0), jcfg), 0)
        model = convert.encoder_from_jax(params, convert.config_from_jax(jcfg), device="cpu")
        return params, model, convert.encoder_to_jax
    if name == "reranker":
        jcfg = je.EncoderConfig.tiny()
        params = nonzero_like(init_reranker_params(jax.random.key(0), jcfg), 1)
        model = convert.reranker_from_jax(params, convert.config_from_jax(jcfg), device="cpu")
        return params, model, convert.reranker_to_jax
    jcfg = dataclasses.replace(jdec.DecoderConfig.tiny(), attn_bias=True)
    params = jdec.init_decoder_params(jax.random.key(0), jcfg)
    if name == "decoder_fused":
        params = fuse_list(params)
        for layer, raw in zip(params["layers"], jdec.init_decoder_params(jax.random.key(0), jcfg)["layers"]):
            layer["bqkv"] = jnp.concatenate([raw["bq"], raw["bk"], raw["bv"]])
    params = nonzero_like(params, 2)
    model = convert.decoder_from_jax(params, convert.decoder_config_from_jax(jcfg), device="cpu")
    return params, model, dec_to_np


@pytest.mark.parametrize("name", ["encoder", "reranker", "decoder", "decoder_fused"])
def test_decay_mask_equals_jax_on_the_per_layer_list(name):
    params, model, to_np_tree = _mask_case(name)
    want = jax_decayed(params)
    got = port_decayed(model, to_np_tree)
    assert got == want
    flat = jax.tree_util.tree_leaves(got)
    assert any(flat) and not all(flat)  # matrices decay, vectors do not


def test_stacked_decoder_mask_decays_the_norm_scales_in_jax_only():
    """A reference defect the port does not inherit: on the stacked tree
    (the one ``tests/test_train.py``'s LM test trains) ``ln1`` / ``ln2`` are
    ``[L, H]`` and JAX's name-and-rank mask decays them; the port decays
    no norm scale. Every other leaf is decayed alike."""
    jcfg = jdec.DecoderConfig.tiny()
    params = nonzero_like(jdec.init_decoder_params(jax.random.key(0), jcfg), 3)
    stacked = jdec.fuse_decoder_params(jdec.stack_decoder_params(params))
    want = jax_decayed(stacked)
    assert want["layers"]["ln1"] and want["layers"]["ln2"]
    model = convert.decoder_from_jax(np_tree(stacked), convert.decoder_config_from_jax(jcfg),
                                     device="cpu")
    got = port_decayed(model, dec_to_np)
    for layer in got["layers"]:
        assert not layer["ln1"] and not layer["ln2"]
        assert {k: v for k, v in layer.items() if k not in ("ln1", "ln2")} == {
            k: v for k, v in want["layers"].items() if k not in ("ln1", "ln2")}
    assert {k: v for k, v in got.items() if k != "layers"} == {
        k: v for k, v in want.items() if k != "layers"}


# --------------------------------------------------------------------------
# the port's behaviour tests
# --------------------------------------------------------------------------


def seeded_encoder(seed=0, cls=EncoderConfig.tiny):
    return convert.init_encoder(cls(), torch.Generator().manual_seed(seed), "cpu")


def test_contrastive_loss_decreases():
    enc = seeded_encoder()
    opt = tt.make_optimizer(lr=3e-4)
    state = tt.init_train_state(enc, opt)
    step = tt.make_train_step(enc.cfg, opt)
    batch = to_torch(contrastive_batch(0))
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_reranker_loss_decreases():
    rr = convert.init_reranker(EncoderConfig.tiny(), torch.Generator().manual_seed(0), "cpu")
    opt = tt.make_optimizer(lr=3e-4)
    state = tt.init_train_state(rr, opt)
    step = tt.make_reranker_train_step(rr.cfg, opt, GROUP)
    batch = to_torch(rerank_batch(1))
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_lm_loss_decreases_and_model_memorizes():
    """One repeated 16-token pattern: after 60 steps the loss is under a
    quarter of the first and greedy decoding continues the pattern."""
    cfg = tdec.DecoderConfig.tiny()
    params = tdec.fuse_decoder_params(tdec.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu"))
    opt = tt.make_optimizer(lr=3e-3)
    state = tt.init_train_state(params, opt)
    step = tt.make_lm_train_step(cfg, opt)
    seq = np.tile(np.arange(2, 18), 3)[:32]
    batch = {"tokens": torch.from_numpy(np.tile(seq, (4, 1))), "mask": torch.ones((4, 32), dtype=torch.int32)}
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(60)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.25 * losses[0], losses[-1]
    with torch.inference_mode():
        logits, _ = tdec.decoder_forward(state.params, torch.from_numpy(seq[None, :16]),
                                         tdec.init_cache(cfg, 1, "cpu"),
                                         torch.zeros((1,), dtype=torch.int32), cfg)
    assert int(logits[0, -1].argmax()) == int(seq[16])


def test_lm_loss_refuses_more_tokens_than_the_cache():
    cfg = dataclasses.replace(tdec.DecoderConfig.tiny(), max_cache=8)
    params = tdec.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="8-slot cache"):
        tt.lm_loss(params, torch.zeros((1, 9), dtype=torch.long), torch.ones((1, 9)), cfg)


def _encoder_case():
    enc = seeded_encoder(1)
    opt = tt.make_optimizer(lr=LR)
    return enc, opt, tt.make_train_step(enc.cfg, opt), to_torch(contrastive_batch(5))


def _decoder_case():
    cfg = tdec.DecoderConfig.tiny()
    params = tdec.init_decoder(cfg, torch.Generator().manual_seed(1), "cpu")
    opt = tt.make_optimizer(lr=LR)
    return params, opt, tt.make_lm_train_step(cfg, opt), to_torch(lm_batch(6))


def _copy(params):
    if isinstance(params, torch.nn.Module):
        import copy

        return copy.deepcopy(params)
    return jax.tree_util.tree_map(lambda t: t.detach().clone(), params)


@pytest.mark.parametrize("case", [_encoder_case, _decoder_case], ids=["encoder", "decoder"])
def test_checkpoint_round_trip(case, tmp_path):
    """A saved state reloads bit for bit into a template of other values,
    and a step after the reload equals a step without it."""
    params, opt, step, batch = case()
    template_params = _copy(params)
    state = tt.init_train_state(params, opt)
    state, _ = step(state, batch)
    path = str(tmp_path / "state.pt")
    tt.save_train_state(path, state)

    template = tt.init_train_state(template_params, opt)
    restored = tt.load_train_state(path, template)
    assert restored is template and restored.step == 1 and restored.opt_state.count == 1
    for want, got in ((tt.named_params(state.params), tt.named_params(restored.params)),
                      (state.opt_state.mu, restored.opt_state.mu),
                      (state.opt_state.nu, restored.opt_state.nu)):
        assert want.keys() == got.keys()
        assert all(torch.equal(want[n], got[n]) for n in want)

    _, m1 = step(state, batch)
    _, m2 = step(restored, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for n, p in tt.named_params(state.params).items():
        assert torch.equal(p, tt.named_params(restored.params)[n]), n


def test_checkpoint_refuses_another_model(tmp_path):
    enc, opt, step, batch = _encoder_case()
    state = tt.init_train_state(enc, opt)
    tt.save_train_state(str(tmp_path / "s.pt"), state)
    params, opt, _, _ = _decoder_case()
    with pytest.raises(ValueError, match="other leaves"):
        tt.load_train_state(str(tmp_path / "s.pt"), tt.init_train_state(params, opt))


@pytest.mark.parametrize("model", ["encoder", "reranker"])
def test_remat_gives_the_same_loss_and_gradients(model):
    """Recomputing each layer runs the same ops on the same inputs: on the
    CPU the loss and every gradient are bit-equal."""
    if model == "encoder":
        m = seeded_encoder(2)
        batch = to_torch(contrastive_batch(7))

        def loss(remat):
            return lambda p: tt.contrastive_loss(p, batch["q_ids"], batch["q_mask"], batch["p_ids"],
                                                 batch["p_mask"], remat=remat)
    else:
        m = convert.init_reranker(EncoderConfig.tiny(), torch.Generator().manual_seed(2), "cpu")
        batch = to_torch(rerank_batch(7))

        def loss(remat):
            return lambda p: tt.reranker_loss(p, batch["pair_ids"], batch["pair_mask"], GROUP,
                                              remat=remat)
    l0, g0 = tt.value_and_grad(loss(False), m)
    l1, g1 = tt.value_and_grad(loss(True), m)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(float(g0[f"{pre}layers.{i}.{w}.weight"].abs().sum()) > 0
               for pre in (("",) if model == "encoder" else ("encoder.",))
               for i in range(2) for w in ("q", "k", "v"))


def test_unused_leaves_get_zero_gradients():
    """BGE-m3's sparse head takes no part in the contrastive loss: its
    gradient is zeros (JAX's), and it still decays."""
    enc = convert.init_sparse_head(seeded_encoder(3), torch.Generator().manual_seed(4))
    batch = to_torch(contrastive_batch(8))
    _, grads = tt.value_and_grad(
        lambda p: tt.contrastive_loss(p, batch["q_ids"], batch["q_mask"], batch["p_ids"],
                                      batch["p_mask"]), enc)
    assert not grads["sparse.weight"].any() and not grads["sparse.bias"].any()


def test_steps_refuse_a_model_of_another_config():
    enc = seeded_encoder()
    opt = tt.make_optimizer()
    step = tt.make_train_step(dataclasses.replace(enc.cfg, layers=3), opt)
    with pytest.raises(ValueError, match="config"):
        step(tt.init_train_state(enc, opt), to_torch(contrastive_batch(0)))


def test_quantized_decoder_weights_cannot_train():
    cfg = tdec.DecoderConfig.tiny()
    params = tdec.quantize_decoder_params(tdec.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="quantized"):
        tt.init_train_state(params, tt.make_optimizer())


# --------------------------------------------------------------------------
# the repairs: flash refuses autograd, the ring path differentiates
# --------------------------------------------------------------------------


def test_flash_attention_refuses_autograd_on_cpu_tensors():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 64)).astype(np.float32))
               for _ in range(3))
    bias = torch.zeros((2, 16))
    want = flash_attention_plain(q, k, v, bias)
    assert torch.equal(flash_attention(q, k, v, bias), want)  # no grad required: the forward
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*einsum"):
        flash_attention(q, k, v, bias)
    with torch.no_grad():
        assert torch.equal(flash_attention(q, k, v, bias), want)
    with torch.inference_mode():
        assert torch.equal(flash_attention(q, k, v, bias), want)


def test_encoder_flash_route_refuses_autograd_and_einsum_trains():
    ids, mask = (torch.from_numpy(x) for x in padded(np.random.default_rng(0), 2, 16, 1024))
    flash = seeded_encoder(cls=lambda: EncoderConfig.tiny(attn_impl="flash"))
    with pytest.raises(RuntimeError, match="no backward"):
        pooled_embeddings(flash, ids, mask)
    with torch.no_grad():
        pooled_embeddings(flash, ids, mask)
    einsum = seeded_encoder(cls=lambda: EncoderConfig.tiny(attn_impl="einsum"))
    pooled_embeddings(einsum, ids, mask).sum().backward()
    assert einsum.layers[0].q.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("fused", [False, True])
def test_decoder_ring_path_runs_backward(fused):
    """With grad enabled the ring's layers are attended as copies: backward
    runs, and the logits and the cache written are bit-equal to the same
    forward under ``inference_mode`` (the same ops on the same values)."""
    cfg = tdec.DecoderConfig.tiny()
    params = tdec.init_decoder(cfg, torch.Generator().manual_seed(0), "cpu")
    if fused:
        params = tdec.fuse_decoder_params(params)
    tt.init_train_state(params, tt.make_optimizer())  # leaves require grad
    toks = torch.from_numpy(lm_batch(0)["tokens"][:2, :20])
    start = torch.tensor([0, 3], dtype=torch.int32)
    cache = tdec.init_cache(cfg, 2, "cpu")
    logits, out = tdec.decoder_forward(params, toks, cache, start, cfg)
    assert out is cache
    logits.square().sum().backward()
    for p in tt.named_params(params).values():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    with torch.inference_mode():
        cache2 = tdec.init_cache(cfg, 2, "cpu")
        want, _ = tdec.decoder_forward(params, toks, cache2, start, cfg)
    assert torch.equal(logits.detach(), want)
    assert torch.equal(cache[0], cache2[0]) and torch.equal(cache[1], cache2[1])
