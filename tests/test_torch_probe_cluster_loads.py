"""The cluster load probe (heimdall_tpu_torch/scripts/probe_cluster_loads.py):
it refuses to run without a card, and on the card (marked ``cuda``) every
case reports a positive number of cycles per load."""

import pytest
import torch

from heimdall_tpu_torch.scripts import probe_cluster_loads as probe


def test_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="runs on the card"):
        probe.main()


@pytest.mark.cuda
def test_probe_reports_every_case(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    import json
    assert probe.main() == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got["cycles_per_load"]) == set(probe.CASES)
    assert all(v > 0 for v in got["cycles_per_load"].values())
