"""Port parity: ring attention (``ops/ring_attention.py``) over ranks of the
gloo process group, and the parameter sharding rules
(``parallel/sharding.py``).

Against the JAX package: its ``dense_attention`` and its ``ring_attention``
under ``shard_map`` on an 8-device ``sp`` axis, on the same f32 inputs
(numpy from a seed), causal and not, with GQA's repeated K/V heads (the
repeat before the ring, as ``models/transformer.py`` does it); forward and
the gradients of ``sum(out * g)``.  The port's ring runs in two spawned
ranks (``tests/_torch_rank_worker.py``), each on its block of the
sequence.  Tolerance: the reference's own ring-against-dense tolerance,
2e-5.  ``partition_specs`` must equal the reference's ``PartitionSpec``s
entry by entry on every mesh shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._torch_rank_worker import spawn_ranks

torch.set_num_threads(1)

RING_TOL = 2e-5
B, S, H, D = 2, 16, 4, 8


def _cases():
    rs = np.random.RandomState(3)
    out = {}
    for causal in (True, False):
        for kv_heads in (H, H // 2):
            q = rs.randn(B, S, H, D).astype(np.float32)
            k = rs.randn(B, S, kv_heads, D).astype(np.float32)
            v = rs.randn(B, S, kv_heads, D).astype(np.float32)
            rep = H // kv_heads  # GQA: the kv heads repeated before the ring
            k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
            out[f"causal={causal},kv={kv_heads}"] = {
                "q": q, "k": k, "v": v, "g": rs.randn(B, S, H, D).astype(np.float32),
                "causal": causal}
    return out


def _reference(case, ring_mesh=None):
    """The reference's output and gradients (dense, or its ring over the
    mesh's ``sp`` axis)."""
    from fedml_tpu.ops.ring_attention import dense_attention, ring_attention

    def f(q, k, v):
        if ring_mesh is None:
            return dense_attention(q, k, v, causal=case["causal"])
        return ring_attention(q, k, v, ring_mesh, axis="sp", causal=case["causal"])

    @jax.jit
    def fwd_bwd(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(g)

    outs = fwd_bwd(*(jnp.asarray(case[n]) for n in "qkvg"))
    return dict(zip(("out", "dq", "dk", "dv"), (np.asarray(o) for o in outs)))


def test_ring_attention_over_two_ranks_matches_the_reference(tmp_path, eight_devices):
    """Causal and not, GQA and not: the port's two-rank ring against the
    reference's dense attention and its 8-device ring, forward and
    backward, within 2e-5; the plain version (``dense_attention``) on the
    whole sequence too."""
    from jax.sharding import Mesh

    from fedml_tpu_torch.ops.attention import dense_attention

    cases = _cases()
    ranks = spawn_ranks("ring", 2, tmp_path, {"cases": cases}, timeout=60.0)
    ring_mesh = Mesh(np.array(eight_devices[:8]), ("sp",))
    for name, case in cases.items():
        got = {k: np.concatenate([r[name][k] for r in ranks], axis=1)
               for k in ("out", "dq", "dk", "dv")}
        dense, ring = _reference(case), _reference(case, ring_mesh)
        for k in got:
            np.testing.assert_allclose(got[k], dense[k], rtol=RING_TOL, atol=RING_TOL,
                                       err_msg=f"{name} {k} vs dense")
            np.testing.assert_allclose(got[k], ring[k], rtol=RING_TOL, atol=RING_TOL,
                                       err_msg=f"{name} {k} vs ring")
        plain = dense_attention(*(torch.from_numpy(case[n]) for n in "qkv"),
                                causal=case["causal"])
        np.testing.assert_allclose(plain.numpy(), dense["out"], rtol=RING_TOL, atol=RING_TOL)


def test_a_ring_of_one_rank_is_dense_attention():
    from fedml_tpu_torch.ops.attention import dense_attention
    from fedml_tpu_torch.ops.ring_attention import Ring, ring_attention

    case = _cases()["causal=True,kv=4"]
    q, k, v = (torch.from_numpy(case[n]) for n in "qkv")
    assert torch.equal(ring_attention(q, k, v, Ring([0], 0)), dense_attention(q, k, v))
    assert torch.equal(ring_attention(q, k, v, None, causal=False),
                       dense_attention(q, k, v, causal=False))


MESHES = {"none": None, "data:8": (("data",), (8,)),
          "data:2,model:4": (("data", "model"), (2, 4)), "model:8": (("model",), (8,)),
          "data:4,seq:2": (("data", "seq"), (4, 2)), "data:1": (("data",), (1,)),
          "model:3": (("model",), (3,))}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_partition_specs_equal_the_reference(eight_devices, mesh):
    """The tiny transformer's parameter specs (vocabulary 100): entry by entry the reference's ``PartitionSpec``s, the degrade rules
    (absent or size-1 axis, non-dividing dim) included; ``batch_sharding``
    too."""
    from flax.core import unfreeze

    from fedml_tpu.models.transformer import Transformer as RefTransformer
    from fedml_tpu.models.transformer import TransformerConfig as RefConfig
    from fedml_tpu.parallel import mesh as ref_mesh
    from fedml_tpu.parallel import sharding as ref_sharding
    from fedml_tpu_torch.models.transformer import Transformer, TransformerConfig
    from fedml_tpu_torch.parallel import mesh as port_mesh
    from fedml_tpu_torch.parallel import sharding

    spec = MESHES[mesh]
    ref_m = port_m = None
    if spec is not None:
        n = int(np.prod(spec[1]))
        ref_m = ref_mesh.make_mesh(spec[0], spec[1], eight_devices[:n])
        port_m = port_mesh.make_mesh(spec[0], spec[1], devices=range(n))
    ref_cfg = RefConfig.tiny(vocab_size=100)  # 100: a vocabulary 8 does not divide
    shapes = jax.eval_shape(lambda: RefTransformer(ref_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    want = ref_sharding.partition_specs(unfreeze(shapes), mesh=ref_m)
    port = Transformer(TransformerConfig.tiny(vocab_size=100), device="meta")
    got = sharding.partition_specs(port.variables(), mesh=port_m)
    want_flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(want_flat) == len(jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(
        x, tuple)))
    for path, ps in want_flat:
        node = got
        for key in path:
            node = node[key.key]
        assert node == tuple(ps), (jax.tree_util.keystr(path), node, ps)
    if port_m is not None:
        for seq in (None, "seq"):
            assert sharding.batch_sharding(port_m, seq_axis=seq) == tuple(
                ref_sharding.batch_sharding(ref_m, seq_axis=seq).spec)
