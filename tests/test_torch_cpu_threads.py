"""Fault F2: every kernel wrapper runs its plain version at one CPU thread.

With two intra-op threads, PyTorch's CPU build on an AMX-capable Xeon
returned a wrong result from the first plain K5 call of a few fresh
processes in a hundred (MKL's AVX-512/AMX float32 product); at one
thread, none. Each wrapper's CPU branch therefore runs its plain version
inside ``device.cpu_single_thread()``. Here, at two threads, each
wrapper (K1–K8) is called on a small input with the module-level plain
function it dispatches to replaced by one that records
``torch.get_num_threads()`` and calls through: the count must be 1
inside every call and 2 again afterwards.
"""

import pytest
import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops.cuda import channel_step, detect_ct, fft_detect, fft_natural, fft_rows, gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import DET, correlated_spectra, pair_gate_scales, tone_rows

cap_cpu_threads()

NFFT, B, LAG = 2048, 4, 64
PLAN = ct_plan.detect_plan(NFFT, **DET)


def _rows():
    re, im = tone_rows(B, NFFT, 0, n_valid=NFFT - LAG)
    return torch.from_numpy(re), torch.from_numpy(im)


def _spectra():
    sre, sim, smax = correlated_spectra(1, B, NFFT, 1)
    pi, pj = gcc_phat.pair_indices(B)
    return torch.from_numpy(sre), torch.from_numpy(sim), torch.from_numpy(smax), pi, pj


def _k5():
    sre, sim, smax, pi, pj = _spectra()
    s2 = torch.from_numpy(pair_gate_scales(smax.numpy(), pi, pj))
    return gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim, pi, pj, max_lag=LAG, s2=s2)


def _k6():
    sre, sim, smax, pi, pj = _spectra()
    s2 = torch.from_numpy(pair_gate_scales(smax[0].numpy(), pi, pj))
    x = [a[0].index_select(0, torch.as_tensor(idx)).contiguous() for idx in (pi, pj) for a in (sre, sim)]
    return gcc_pair.gcc_rows_lag_mags(*x, max_lag=LAG, s2=s2)


CALLS = {  # kernel → (module, plain function the wrapper dispatches to, call)
    "K1": (fft_detect, "fft_detect_rows_ct_plain", lambda: fft_detect.fft_detect_rows_ct(*_rows(), PLAN)),
    "K2": (gcc_pair, "_k2_plain",
           lambda: gcc_pair.gcc_pair_lag_mags(*_spectra(), max_lag=LAG)),
    "K3": (fft_rows, "fft_rows_ct_plain", lambda: fft_rows.fft_rows_ct(*_rows())),
    "K4": (detect_ct, "detect_ct_partials_plain",
           lambda: detect_ct.detect_ct_partials(*fft_rows.fft_rows_ct(*_rows()), PLAN)),
    "K5": (gcc_pair, "gcc_pairs_onehot_lag_mags_plain", _k5),
    "K6": (gcc_pair, "gcc_rows_lag_mags_plain", _k6),
    "K7": (fft_natural, "fft_rows_plain", lambda: fft_natural.fft_rows(*_rows())),
    "K8": (channel_step, "channel_step_partials_plain",
           lambda: channel_step.channel_step_partials(
               *(x.reshape(1, B, NFFT) for x in _rows()), *gcc_phat.pair_indices(B), PLAN, LAG)),
}


@pytest.mark.parametrize("kernel", sorted(CALLS))
def test_plain_version_runs_at_one_thread_and_restores_the_count(kernel, monkeypatch):
    module, name, call = CALLS[kernel]
    plain = getattr(module, name)
    seen = []

    def recording(*args, **kwargs):
        seen.append(torch.get_num_threads())
        return plain(*args, **kwargs)

    monkeypatch.setattr(module, name, recording)
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        out = call()
        after = torch.get_num_threads()
    finally:
        torch.set_num_threads(before)
    assert seen == [1]
    assert after == 2
    assert out is not None


def test_cpu_single_thread_restores_the_count_on_an_exception():
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        with pytest.raises(RuntimeError):
            with device.cpu_single_thread():
                assert torch.get_num_threads() == 1
                raise RuntimeError("inside")
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(before)
