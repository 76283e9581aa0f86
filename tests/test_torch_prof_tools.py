"""The probe entry point's tools on the CPU (linr_pcgc_tpu_torch/tools):
prof_probes and trace_edges need the card, a trace that lost launches is
taken again, and K7's trace splits from its launch-floor yardstick by
kernel name.  No JAX."""

import pytest
import torch

from linr_pcgc_tpu_torch.ops import probes


def test_prof_probes_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from linr_pcgc_tpu_torch.tools import prof_probes

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prof_probes.main()


@pytest.mark.parametrize("traces, want", [
    ([[("k", 50, 10.0)]], 0),
    ([[], [("k", 49, 9.8)], [("k", 50, 10.0), ("fill", 100, 2.0)]], 2),
    ([[], [], []], 2),
    ([[], [("k", 37, 7.4)], [("k", 41, 8.2)]], 2),
])
def test_device_activity_takes_the_trace_again_until_it_is_whole(monkeypatch, traces, want):
    """A trace that records no launch, or a count that is not a multiple of
    the calls, is taken again, up to TRACES times; the last is kept."""
    from linr_pcgc_tpu_torch.tools import prof_probes

    taken = []

    def fake_trace(fn, reps, edge_s=prof_probes.EDGE_S):
        assert edge_s > 0 and reps == 50
        taken.append(fn)
        return traces[len(taken) - 1]

    monkeypatch.setattr(prof_probes, "_trace", fake_trace)
    monkeypatch.setattr(prof_probes.torch.cuda, "synchronize", lambda: None)
    acts = prof_probes.device_activity(lambda: None, 50)
    assert acts == traces[want] and len(taken) == want + 1 <= prof_probes.TRACES
    if acts:
        assert prof_probes.device_ms(None, 50, acts) == sum(us for *_, us in acts) / 50 / 1e3
    else:
        with pytest.raises(RuntimeError, match="no device time"):
            prof_probes.device_ms(None, 50, acts)


def test_launch_floor_yardstick_is_card_only_and_split_by_name():
    """The empty yardstick kernel launches on a card only (no CPU form), and
    a trace of K7's calls beside it splits by kernel name into K7's
    activities and the yardstick's."""
    from linr_pcgc_tpu_torch.tools import prof_probes

    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="CUDA device"):
            probes.probe_empty(dev)
    acts = [("void (anonymous namespace)::probe_scale_shift_kernel(float const*, float*, "
             "long long)", 50, 60.0), ("void (anonymous namespace)::probe_empty_kernel()", 50,
                                       45.0)]
    k7, empty = prof_probes.split_launch_floor(acts)
    assert k7 == acts[:1] and empty == acts[1:]
    assert prof_probes.device_ms(None, 50, empty) == 45.0 / 50 / 1e3


def test_trace_edges_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from linr_pcgc_tpu_torch.tools import trace_edges

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trace_edges.main([])
