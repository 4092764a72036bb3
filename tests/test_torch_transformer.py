"""Port parity: the llama-style transformer, dense attention, LoRA and adamw.

The same numpy inputs and the reference's flax parameters (copied leaf for
leaf: the port keeps flax's layouts) go through ``fedml_tpu.models.
transformer`` and ``fedml_tpu_torch.models.transformer``.

Tolerances:
- f32 (``dtype`` and ``logits_dtype`` f32): logits within atol 2e-5 /
  rtol 1e-5 (measured 3e-6 at |logits| ~3.4), the loss within rtol 1e-6;
- bf16 (the shipped dtypes): logits within atol 8e-2, five bf16 ulps at
  the logits' magnitude of ~3.4 (measured 0.047).  Every Dense rounds its
  output to bf16, so an f32 difference of one ulp before a rounding
  boundary moves a value by a whole bf16 ulp; already with no layer (the
  embedding, RMSNorm and the head) the two differ by 1.5e-3;
- bf16 stage by stage, each stage given the reference's own input: every
  stage's dtype as flax's; the embedding bitwise; the norms, the
  projections, attention and the head within one bf16 ulp of each element
  (measured 0.83 for the norm, 0 for the rest); the MLP within atol
  2**-6, one bf16 ulp at its largest output of ~2.2 (measured 2**-6: jax
  rounds its sigmoid op by op, ``torch.sigmoid`` once; with the sigmoid
  as jax's the MLP reads 2**-9);
- attention alone, in f32: atol 1e-6;
- ``merge`` and adamw: 1e-6 relative (one product ``a @ b`` in another
  order) and bitwise against optax called eagerly.
Remat on against off is bitwise, forward and gradients.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

VOCAB = 64


def _tree_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    import jax.numpy as jnp

    from fedml_tpu.models.transformer import TransformerConfig as RefConfig
    from fedml_tpu_torch.models.transformer import TransformerConfig

    f32 = kw.pop("f32", True)
    ref = dataclasses.replace(RefConfig.tiny(vocab_size=VOCAB), remat=False, **kw)
    cfg = dataclasses.replace(TransformerConfig.tiny(vocab_size=VOCAB), remat=False, **kw)
    if f32:
        ref = dataclasses.replace(ref, dtype=jnp.float32, logits_dtype=jnp.float32)
        cfg = dataclasses.replace(cfg, dtype=torch.float32, logits_dtype=torch.float32)
    return ref, cfg


def _reference(ref_cfg, tokens, seed=0):
    import jax
    import jax.numpy as jnp

    from fedml_tpu.models.transformer import Transformer

    model = Transformer(ref_cfg)
    params = model.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(tokens))["params"]
    return model, params


def _tokens(seed=0, shape=(2, 24)):
    return np.random.RandomState(seed).randint(0, VOCAB, shape).astype(np.int32)


def _port(cfg, params):
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.models.transformer import Transformer

    return Transformer(cfg), weights.tree_from_flax(_tree_np(params))


def test_variable_tree_matches_flax_names_and_layouts():
    from fedml_tpu_torch.core import pytree as pt

    ref_cfg, cfg = _configs(n_kv_heads=2)
    _, params = _reference(ref_cfg, _tokens())
    model, _ = _port(cfg, params)
    import jax

    ref_leaves = jax.tree_util.tree_flatten_with_path(_tree_np(params))[0]
    ref_paths = ["/".join(p.key for p in path) for path, _ in ref_leaves]
    ours = model.variables()
    from fedml_tpu_torch.llm.lora import _paths

    assert [p for p, _ in _paths(ours)] == ref_paths
    assert [tuple(t.shape) for t in pt.tree_leaves(ours)] == [a.shape for _, a in ref_leaves]
    assert ours["layer_0"]["attn"]["wk"]["kernel"].shape == (128, 2, 32)
    assert ours["layer_0"]["attn"]["wo"]["kernel"].shape == (4, 32, 128)
    assert ours["lm_head"]["kernel"].shape == (128, VOCAB)


@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_f32_logits_and_loss_match_reference(n_kv_heads):
    """(a) f32 logits and the FedLLM loss; GQA with n_kv_heads=2 repeats
    each kv head for its query heads as ``jnp.repeat`` does."""
    import jax.numpy as jnp
    import optax

    from fedml_tpu_torch.llm.fedllm import lm_loss

    ref_cfg, cfg = _configs(n_kv_heads=n_kv_heads)
    tokens = _tokens(1)
    targets = _tokens(2)
    ref_model, params = _reference(ref_cfg, tokens)
    want = np.asarray(ref_model.apply({"params": params}, jnp.asarray(tokens)))
    ref_loss = float(optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(want), jnp.asarray(targets)).mean())
    model, tree = _port(cfg, params)
    got = model(torch.from_numpy(tokens).long(), tree)
    assert got.dtype == torch.float32 and got.shape == (2, 24, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=1e-5)
    loss = float(lm_loss(got, torch.from_numpy(targets).long()))
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)


def test_bf16_logits_match_reference():
    """(a) the shipped dtypes: bf16 activations and logits."""
    import jax.numpy as jnp

    ref_cfg, cfg = _configs(f32=False)
    tokens = _tokens(3)
    ref_model, params = _reference(ref_cfg, tokens)
    want = np.asarray(ref_model.apply({"params": params}, jnp.asarray(tokens)).astype(jnp.float32))
    model, tree = _port(cfg, params)
    got = model(torch.from_numpy(tokens).long(), tree)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(), want, atol=8e-2)


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of each element of ``want``."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    return np.abs(got - want) / ulp


def test_bf16_stages_keep_flax_dtypes():
    """(a) the shipped dtypes stage by stage.  flax's captured
    intermediates give each stage of the port the reference's own input,
    so a wrong cast shows at its stage and not only in the logits: the
    embedding and the residual stream bf16, every RMSNorm f32 (its scales
    drawn away from 1, so a bf16 scale would show), the projections, the
    attention, the MLP and the head bf16 from bf16 operands (a product in
    f32 rounded once would show)."""
    import jax
    import jax.numpy as jnp

    from fedml_tpu_torch.models import transformer as port

    ref_cfg, cfg = _configs(f32=False)
    tokens = _tokens(3)
    ref_model, params = _reference(ref_cfg, tokens)
    rs = np.random.RandomState(12)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(1 + 0.3 * rs.randn(*a.shape).astype(np.float32))
                         if path[-1].key == "scale" else a), params)
    _, state = ref_model.apply({"params": params}, jnp.asarray(tokens),
                               capture_intermediates=True)

    def ref(*keys):
        node = state["intermediates"]
        for k in keys:
            node = node[k]
        return node["__call__"][0]

    def as_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)

    model, tree = _port(cfg, params)
    p0, layer = tree["layer_0"], model.layer_0
    positions = torch.arange(tokens.shape[1]).expand(*tokens.shape)

    def check(got, want, ulps=1.0):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
        assert _bf16_ulps(got, want.astype(jnp.float32)).max() <= ulps

    embed = tree["embed"]["embedding"][torch.from_numpy(tokens).long()].to(cfg.dtype)
    check(embed, ref("embed"), ulps=0)
    x = as_torch(ref("embed"))
    check(layer.attn_norm(x, p0["attn_norm"]), ref("layer_0", "attn_norm"))
    h = as_torch(ref("layer_0", "attn_norm"))
    for w in ("wq", "wk", "wv"):
        check(port._dense(h, p0["attn"][w]["kernel"], cfg.dtype), ref("layer_0", "attn", w))
    check(layer.attn(h, positions, p0["attn"]), ref("layer_0", "attn"))
    mlp = layer.mlp(as_torch(ref("layer_0", "mlp_norm")), p0["mlp"])
    assert mlp.dtype == torch.bfloat16
    np.testing.assert_allclose(mlp.float().detach().numpy(),
                               np.asarray(ref("layer_0", "mlp").astype(jnp.float32)),
                               atol=2.0 ** -6, rtol=0)
    assert ref("layer_0").dtype == jnp.bfloat16
    assert layer(x, positions, p0).dtype == torch.bfloat16  # the residual stream
    check(model.final_norm(as_torch(ref("layer_1")), tree["final_norm"]), ref("final_norm"))
    check(port._dense(as_torch(ref("final_norm")), tree["lm_head"]["kernel"], cfg.logits_dtype),
          ref("lm_head"))


def test_rmsnorm_returns_f32_and_rope_matches():
    """RMSNorm on a bf16 input returns f32 (the bf16 product times the f32
    scale promotes); rope casts back to its input's dtype bitwise."""
    import jax.numpy as jnp

    from fedml_tpu.models import transformer as ref
    from fedml_tpu_torch.models import transformer as port

    x = np.random.RandomState(4).randn(2, 10, 4, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(10), (2, 10))
    want = np.asarray(ref.rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos),
                               10000.0).astype(jnp.float32))
    got = port.rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos.copy()), 10000.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    norm = port.RMSNorm(32)
    with torch.no_grad():
        norm.scale.fill_(1.5)
    out = norm(torch.from_numpy(x).bfloat16(), {"scale": norm.scale})
    assert out.dtype == torch.float32


def test_dense_attention_matches_reference():
    import jax.numpy as jnp

    from fedml_tpu.ops.ring_attention import dense_attention as ref_attn
    from fedml_tpu_torch.ops.attention import dense_attention

    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3))
    for causal in (True, False):
        want = np.asarray(ref_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
        got = dense_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    half = dense_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert half.dtype == torch.bfloat16


def test_causality():
    """Future tokens do not change past logits (bitwise in f32)."""
    _, cfg = _configs()
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.models.transformer import Transformer

    model = Transformer(cfg).reset_parameters(rng.generator((0,)))
    t1 = torch.from_numpy(_tokens(6, (1, 32))).long()
    t2 = t1.clone()
    t2[:, 20:] = torch.from_numpy(_tokens(7, (1, 12))).long()
    with torch.no_grad():
        l1, l2 = model(t1), model(t2)
    assert torch.equal(l1[:, :20], l2[:, :20])
    assert not torch.equal(l1[:, 20:], l2[:, 20:])


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_on_and_off_bitwise(policy):
    """Checkpointing each block changes no number: logits and the
    adapters' gradients bitwise with remat off.  Both of the reference's
    policies are accepted, and both recompute the whole block."""
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.core import rng
    from fedml_tpu_torch.llm import lora as lora_lib
    from fedml_tpu_torch.llm.fedllm import lm_loss
    from fedml_tpu_torch.models.transformer import Transformer

    _, cfg = _configs(f32=False)
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        model = Transformer(c).reset_parameters(rng.generator((0,))).requires_grad_(False)
        base = model.variables()
        lora = lora_lib.init_lora(base, 4, (1,))
        lora = pt.tree_map(lambda t: (t + 0.01).requires_grad_(True), lora)
        tokens = torch.from_numpy(_tokens(8)).long()
        logits = model(tokens, lora_lib.merge(base, lora))
        loss = lm_loss(logits, torch.from_numpy(_tokens(9)).long())
        grads = torch.autograd.grad(loss, pt.tree_leaves(lora))
        outs.append((logits.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def _ref_lora_setup(rank=4):
    import jax

    from fedml_tpu.llm import lora as ref_lora

    ref_cfg, _ = _configs()
    _, params = _reference(ref_cfg, _tokens())
    return params, ref_lora.init_lora(params, rank=rank, key=jax.random.PRNGKey(1))


def test_lora_init_layout_and_merge_identity():
    """Adapters keyed by the flax path in the reference's order, ``a: (d_in,
    r)``, ``b: (r, prod(rest))`` (``wo``: ``(heads, r)``, ``(r, head_dim *
    d_model)``), ``b`` zero so the merge is the identity; lora_size."""
    from fedml_tpu.llm import lora as ref_lora
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.llm import lora as lora_lib

    params, ref = _ref_lora_setup()
    base = weights.tree_from_flax(_tree_np(params))
    ours = lora_lib.init_lora(base, 4, (0, 2))
    assert list(ours) == list(ref) == sorted(ref)
    for path, ab in ours.items():
        assert ab["a"].shape == ref[path]["a"].shape and ab["b"].shape == ref[path]["b"].shape
        assert not ab["b"].any()
    assert ours["layer_0/attn/wo/kernel"]["a"].shape == (4, 4)
    assert ours["layer_0/attn/wo/kernel"]["b"].shape == (4, 32 * 128)
    assert lora_lib.lora_size(ours) == ref_lora.lora_size(ref)
    merged = lora_lib.merge(base, ours)
    from fedml_tpu_torch.core import pytree as pt

    assert all(torch.equal(a, b) for a, b in zip(pt.tree_leaves(merged), pt.tree_leaves(base)))
    with pytest.raises(ValueError, match="no parameters matched"):
        lora_lib.init_lora(base, 4, (0,), targets=r"nothing/.*")


def test_lora_merge_with_random_adapters_matches_reference():
    """Random ``a`` and ``b`` on every target, ``wo`` included: the merged
    tree matches the reference's, and the merge is differentiable in the
    adapters only."""
    import jax
    import jax.numpy as jnp

    from fedml_tpu.llm import lora as ref_lora
    from fedml_tpu_torch import weights
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.llm import lora as lora_lib

    params, ref = _ref_lora_setup()
    rs = np.random.RandomState(10)
    ref = {p: {k: jnp.asarray(rs.randn(*v.shape).astype(np.float32)) for k, v in ab.items()}
           for p, ab in ref.items()}
    want = _tree_np(ref_lora.merge(params, ref, alpha=16.0))
    base = weights.tree_from_flax(_tree_np(params))
    lora = weights.tree_from_flax(_tree_np(ref))
    pt.tree_map(lambda t: t.requires_grad_(True), lora)
    got = lora_lib.merge(base, lora, alpha=16.0)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], pt.tree_leaves(got)):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-6, atol=1e-6, err_msg=str(path))
    wo = got["layer_1"]["attn"]["wo"]["kernel"]
    assert wo.requires_grad and wo.shape == (4, 32, 128)
    assert not got["layer_1"]["mlp"]["w_up"]["kernel"].requires_grad


def test_adamw_matches_optax_eager():
    """``fl/optim.adamw(lr)``: optax ``adamw`` with its defaults (weight
    decay 1e-4 on every leaf, the zero ``b`` included), bitwise eagerly."""
    import jax.numpy as jnp
    import optax

    from fedml_tpu_torch.fl.optim import adamw

    rs = np.random.RandomState(11)
    params = {"l/wq": {"a": rs.randn(8, 4).astype(np.float32),
                       "b": np.zeros((4, 12), np.float32)}}
    grads = [{p: {k: (rs.randn(*v.shape) * 0.1).astype(np.float32) for k, v in ab.items()}
              for p, ab in params.items()} for _ in range(3)]
    opt = optax.adamw(0.005)
    ref_p = {p: {k: jnp.asarray(v) for k, v in ab.items()} for p, ab in params.items()}
    ref_s = opt.init(ref_p)
    ours = {p: {k: torch.from_numpy(v.copy()) for k, v in ab.items()} for p, ab in params.items()}
    port = adamw(0.005)
    state = port.init(ours)
    for g in grads:
        u, ref_s = opt.update({p: {k: jnp.asarray(v) for k, v in ab.items()}
                               for p, ab in g.items()}, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, u)
        ours, state = port.update({p: {k: torch.from_numpy(v) for k, v in ab.items()}
                                   for p, ab in g.items()}, state, ours)
    for p, ab in ours.items():
        for k, v in ab.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref_p[p][k]))
