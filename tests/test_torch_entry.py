"""The port's entry points: ``entry()`` against the JAX package's, and
``dryrun_multichip`` on 4 CPU ranks.

- ``entry()``'s arguments equal the JAX ``__graft_entry__.entry()``'s bit
  for bit (the same numpy draws) and its step returns finite fixes of the
  same shape; the inputs are noise, so values are not compared.
- ``dryrun_multichip(4, device="cpu")`` runs every leg (sharded split
  step, config 5, EP at 64 and 256 receivers, the flagship split over
  channels, the sharded wideband step) and checks the shapes the JAX
  dry run asserts; the EP fixes are identical on every rank.
"""

import numpy as np
import torch

import __graft_entry__ as jentry

from radio_mapper_tpu_torch import entry
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def test_entry_matches_jax_inputs_and_runs():
    fn, args = entry.entry(device="cpu")
    _, jargs = jentry.entry()
    for a, r in zip(args, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    out = fn(*args)
    assert out.fix.position_enu.shape == (2, 3)
    assert torch.isfinite(out.fix.position_enu).all()


def test_dryrun_multichip_on_four_cpu_ranks():
    summaries = entry.dryrun_multichip(4, device="cpu")
    assert len(summaries) == 4
    s = summaries[0]
    assert s["sharded"] == (2, 4, 8, 3)
    assert s["config5"] == (2, 256, 16, 3)
    assert s["flagship"] == (32, 3)
    assert s["wideband"] == (8, 3)
    for leg in ("ep64", "ep256"):
        assert s[leg].shape == (3,) and np.isfinite(s[leg]).all()
        for other in summaries[1:]:
            np.testing.assert_array_equal(other[leg], s[leg])
