"""The plain reference's pieces: Philox4x32-10 against its published
answers, and B1's bulk follower against the law stepped one step at a
time."""
import pytest
import torch

import portbench_tiny  # noqa: F401  (puts the checkout on the path)
from portbench.reference import meanfield as ref_mf
from portbench.reference.philox import philox4x32_10


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    got = philox4x32_10(*(torch.tensor([c]) for c in ctr), *key)
    assert tuple(int(x) for x in got) == want


def _law(frames=4):
    L, n = 16, 40
    dt = ref_mf.b1_dt(20.0, 3.0, 3.0)
    n_sub = ref_mf.n_substeps(0.5, dt)
    return ref_mf.MeanfieldLaw(
        L=L, n=n, beta=torch.tensor([0.0, 1.5, 3.0]), rate_diffusion=20.0,
        rate_active=3.0, dt=0.5 / n_sub, n_sub=n_sub, frames=frames,
        device=torch.device("cpu"))


@pytest.mark.parametrize("b", [0, 1, 2])
def test_b1_bulk_follower_steps_the_law(b):
    """The follower's frames equal the law applied a step at a time on
    the same Philox uniforms (many flips: β up to 3, flip-heavy rates)."""
    law = _law()
    pos, sig, seeds, _ = ref_mf.sweep_inputs(7, 3, law.n, law.L, law.device)
    t1, t2, t3 = (t[b] for t in law.thresholds())
    up, sg = pos[b].long().clone(), sig[b].long().clone()
    want = []
    for f in range(1, law.frames):
        u_all = ref_mf._uniforms(int(seeds[b]), b, -(-law.n // 4), law.n,
                                 (f - 1) * law.n_sub, f * law.n_sub,
                                 law.device)
        for u in u_all:
            e_p, e_m = law.flip_probs(sg.sum(), law.beta[b])
            t4 = t3 + torch.where(sg > 0, e_p, e_m)
            flip = (u >= t3) & (u < t4)
            up = up + torch.where(u < t1, -1, torch.where(
                u < t2, 1, torch.where(u < t3, sg, 0)))
            sg = torch.where(flip, -sg, sg)
        want.append((up.clone(), sg.clone()))
    got = list(ref_mf.follow_replica(law, b, int(seeds[b]), pos[b], sig[b],
                                     chunk=97))
    assert len(got) == len(want)
    for (gu, gs), (wu, ws) in zip(got, want):
        assert torch.equal(gu, wu) and torch.equal(gs, ws)

