"""Port parity: vertical FL (``fedml_tpu_torch/sim/vertical.py``) against
``fedml_tpu/sim/vertical.py``.

2 and 3 parties over ``synthetic``'s 60 features (3 parties: 20 each; and
over ``lending_club`` narrowed to 61 features, zero-padded to 62 and 63),
2 rounds of 8 joint steps a round (64 rows, batch 8, f32), the reference's
epoch permutations injected and its initial weights copied: the parties'
bottoms, the host's top, the losses and the test accuracy within 1e-5
relative (measured 3.4e-8 to 4.6e-8).  The party slices bitwise, and
the parties' one ``bmm`` a layer against each party's bottom alone within
1e-6.
"""

import numpy as np
import pytest
import torch

from .test_torch_split_learning import JaxOwnSampler, _cfgs, _datasets, flat, port_vars, ref_flat, rel

torch.set_num_threads(1)

TOL = 1e-5


def _pair(tmp_path, parties, dataset, monkeypatch):
    from fedml_tpu.data import loader as ref_loader
    from fedml_tpu.sim.vertical import VFLSimulator as Ref
    from fedml_tpu_torch.data import loader
    from fedml_tpu_torch.sim.vertical import VFLSimulator

    if dataset == "lending_club":  # an odd feature count: the padded slices
        for mod in (loader, ref_loader):
            monkeypatch.setitem(mod._DATASET_SPECS, "lending_club", ((61,), 2, 50000, 10000))
    ref_cfg, cfg = _cfgs(tmp_path, "vertical_fl", dataset=dataset,
                         extra={"vfl_party_num": parties, "vfl_embed_dim": 4})
    ref_ds, ds = _datasets(ref_cfg, cfg)
    ref = Ref(ref_cfg, ref_ds)
    sim = VFLSimulator(cfg, ds, device="cpu", sampler=JaxOwnSampler(ref.root_key))
    sim.party_vars = port_vars(ref.party_vars, lanes=True)
    sim.top_vars = port_vars(ref.top_vars)
    return ref, sim


@pytest.mark.parametrize("parties,dataset", [(2, "synthetic"), (3, "synthetic"),
                                             (2, "lending_club"), (3, "lending_club")])
def test_two_rounds_match_the_reference(tmp_path, monkeypatch, parties, dataset):
    ref, sim = _pair(tmp_path, parties, dataset, monkeypatch)
    np.testing.assert_array_equal(sim.train_x.numpy(), np.asarray(ref.train_x))
    np.testing.assert_array_equal(sim.test_x.numpy(), np.asarray(ref.test_x))
    assert sim.slice_w == ref.slice_w and sim.hp.local_steps == ref.hp.local_steps == 8
    start = ref_flat(ref.party_vars, lanes=True)
    for _ in range(2):
        want_m, got_m = ref.run_round(), sim.run_round()
        np.testing.assert_allclose(got_m["train_loss"], want_m["train_loss"], rtol=TOL)
        assert rel(flat(sim.party_vars), ref_flat(ref.party_vars, lanes=True)) <= TOL
        assert rel(flat(sim.top_vars), ref_flat(ref.top_vars)) <= TOL
    assert np.abs(ref_flat(ref.party_vars, lanes=True) - start).max() > 1e-4
    np.testing.assert_allclose(sim.evaluate()["test_acc"], ref.evaluate()["test_acc"], rtol=TOL)


def test_party_bmm_equals_each_party_alone():
    from fedml_tpu_torch.core import pytree as pt
    from fedml_tpu_torch.sim.vertical import PartyBottom

    bottom = PartyBottom(in_features=7, embed_dim=5)
    parties = [bottom.init(torch.Generator().manual_seed(s)) for s in range(3)]
    x = torch.randn(3, 11, 7, generator=torch.Generator().manual_seed(9))
    together, _ = bottom.apply(pt.tree_stack(parties), x)
    for p in range(3):
        torch.testing.assert_close(together[p], bottom.apply(parties[p], x[p])[0],
                                   rtol=1e-6, atol=1e-6)
