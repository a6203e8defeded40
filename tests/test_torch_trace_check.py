"""ProfilingSession.trace's check of a trace taken on the card, with the
profiler and the card stubbed (this machine has neither): a trace whose
first kernel after its lead of fill kernels (which the profiler may drop,
all or some: heimdall_tpu_torch/scripts/check_trace.py) and whose last
kernel are the two spin kernels that bracket the block passes and counts
the card's kernels; one that lost either spin raises RuntimeError naming
the loss, after writing the files.  No JAX."""

import contextlib
import json
import os
import types

import pytest
import torch

from heimdall_tpu_torch.perf import profiling

SPIN = "spin_kernel(long)"
LEAD = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>, std::array<char*, 1ul> >")


class _Profile:
    """torch.profiler.profile's stand-in: its Chrome trace lists `kernels`
    in order."""

    def __init__(self, kernels):
        self.kernels = kernels

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 + i}
                  for i, n in enumerate(self.kernels)]
        events.append({"ph": "X", "cat": "cpu_op", "name": "aten::add",
                       "ts": 0.0})
        with open(path, "w") as fh:
            json.dump({"traceEvents": events[::-1]}, fh)

    def key_averages(self):
        return types.SimpleNamespace(table=lambda **kw: "table")


@pytest.fixture
def card_trace(monkeypatch):
    """Stubs the card and the profiler; returns a setter for the kernels
    the stubbed trace lists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(profiling, "lead", lambda device: None)

    def listing(kernels):
        monkeypatch.setattr(torch.profiler, "profile",
                            lambda activities: _Profile(kernels))
    return listing


@pytest.mark.parametrize("lead", [0, 3, profiling.LEAD_KERNELS])
def test_complete_trace_counts_the_card_kernels(card_trace, tmp_path, lead):
    kernels = [LEAD] * lead + [SPIN, "k_label_tiles", "k_stats", SPIN]
    card_trace(kernels)
    session = profiling.ProfilingSession("t", device="cuda")
    with session.trace(str(tmp_path)):
        pass
    assert session.trace_kernels == len(kernels)
    assert os.path.exists(session.trace_path)


@pytest.mark.parametrize("kernels, lost", [
    (["k_label_tiles", "k_stats", SPIN], "opening"),
    ([SPIN, "k_label_tiles", "k_stats"], "closing"),
    (["k_stats"], "opening and no closing"),
    ([], "opening and no closing"),
    # the block's own spin does not stand in for a lost opening one
    (["k_a", SPIN, "k_b", SPIN], "opening"),
    # nor does the lead
    ([LEAD, LEAD, "k_a", SPIN], "opening"),
    ([LEAD] * 3, "opening and no closing"),
])
def test_trace_missing_a_spin_raises(card_trace, tmp_path, kernels, lost):
    card_trace(kernels)
    session = profiling.ProfilingSession("t", device="cuda")
    with pytest.raises(RuntimeError, match=f"lost the card's kernels: no "
                                           f"{lost} spin"):
        with session.trace(str(tmp_path)):
            pass
    assert session.trace_kernels == len(kernels)
    assert os.path.exists(session.trace_path)


def test_cpu_trace_is_as_it_was(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "_sleep", None)     # no spin kernel
    session = profiling.ProfilingSession("t", device="cpu")
    with session.trace(str(tmp_path)):
        torch.ones(4).add_(1)
    assert session.trace_kernels is None
    assert "aten::add_" in session.trace_table
