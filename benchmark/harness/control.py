"""The control: the plain reference put in the program's place, computed
one precision below the configuration's (TF32 for float32).

``ReferenceProgram(step, tf32=True).step_split_uint8(raw, anchors)``
returns what the program returns, with the fields the check reads
(peaks: bins, validity, powers, floor; pair lags and PSRs; fixes), from
:mod:`reference.tdoa` with every transform's operands and results and
every cross power rounded to TF32. The check must call it incorrect.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from reference import tdoa


class ReferenceProgram:
    def __init__(self, step: tdoa.Step, tf32: bool = True):
        self.step = step
        self.p = tdoa.Precision(tf32)

    def step_split_uint8(self, raw: torch.Tensor, anchors: torch.Tensor, *, on_stage=None):
        st = self.step
        b, k = st.num_buoys, st.max_peaks
        lead = raw.shape[:-2]
        flat = raw.reshape(-1, *raw.shape[-2:])
        chunk = tdoa.chunk_blocks(st)
        parts = []
        for s in range(0, flat.shape[0], chunk):
            r = tdoa.reference_chunk(flat[s:s + chunk], anchors, st, self.p)
            c = r.fix.shape[0]
            top, bins = r.detection.top_db, r.detection.top_bins
            valid = torch.isfinite(top)
            parts.append((
                torch.where(valid, bins, 0).reshape(c, b, k), valid.reshape(c, b, k),
                torch.where(valid, top, 0.0).reshape(c, b, k), r.detection.floor_db.reshape(c, b),
                r.lag.to(torch.float32), r.psr, r.fix.to(torch.float32),
            ))
        cat = [torch.cat(f) for f in zip(*parts)]
        shape = lambda t: t.reshape(*lead, *t.shape[1:])
        bins, valid, power, floor, lag, psr, fix = (shape(t) for t in cat)
        return SimpleNamespace(
            peaks=SimpleNamespace(bin_index=bins, valid=valid, power_db=power, noise_floor_db=floor),
            correlation=SimpleNamespace(lag_samples=lag, psr=psr),
            fix=SimpleNamespace(position_enu=fix),
        )
