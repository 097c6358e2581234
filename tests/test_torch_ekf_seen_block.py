"""The invariant the EKF and RI-EKF kernels' seen-block walk rests on.

``csrc/fused_ekf_rollout.cu`` walks only the block of P up to D_act = 3 + 2
(1 + the highest landmark id seen or visible in the tick), because every
entry of P's rows and columns, and of x, that belongs to a landmark not yet
seen holds exactly +0 (all bits clear) and every pass leaves it so. The plain
version computes those entries: here it shows that they are +0, bit for bit,
for both filters, the three configs ``chip_smoke.py`` checks, predicated and
not, on maps whose ids are not relabelled by the tour (so unseen ids sit
between seen ones, not only at the end).
"""

import pytest
import torch

from chip_smoke import configs
from live_ekf_slam_tpu_torch.eval.runner import mc_inputs
from live_ekf_slam_tpu_torch.ops import fused_rollout as fr

B = 8  # worlds with a map each, ids in map order


@pytest.mark.parametrize("steps", [25, 200])
@pytest.mark.parametrize("predicated", [True, False], ids=["pred", "unpred"])
@pytest.mark.parametrize("kind", ["default", "compat", "calibrated"])
@pytest.mark.parametrize("filter_kind", ["ekf", "iekf"])
def test_unseen_landmarks_hold_positive_zero(filter_kind, kind, predicated, steps):
    cfg = configs(steps)[kind].replace(filter=filter_kind + "_slam")
    lms, cmds = mc_inputs(cfg, B, 7, "cpu")
    out = fr.fused_ekf_rollout(cfg, lms, cmds, 3, predicated=predicated,
                               filter_kind=filter_kind)
    seen = out["seen"]
    n = seen.shape[1]
    unseen = ~seen
    assert unseen.any() and seen.any()
    # somewhere an unseen id lies below a seen one: not a suffix of the map
    ids = torch.arange(n)
    highest_seen = torch.where(seen, ids, -1).amax(dim=1)
    assert bool((unseen & (ids[None] < highest_seen[:, None])).any())
    # state slots 3 + 2j and 4 + 2j of each unseen landmark j
    slot = torch.zeros((B, 3 + 2 * n), dtype=torch.bool)
    slot[:, 3::2] = unseen
    slot[:, 4::2] = unseen
    xbits = out["x"].view(torch.int32)
    pbits = out["P"].view(torch.int32)
    assert bool((xbits[slot] == 0).all())
    rows = slot[:, :, None].expand_as(pbits)
    cols = slot[:, None, :].expand_as(pbits)
    assert bool((pbits[rows | cols] == 0).all())
    # and the seen landmarks' own block is not: the test looks at live slots
    assert bool((pbits[~(rows | cols)] != 0).any())
