"""linr_pcgc_tpu_torch.utils: the span timer and its summary (JAX's keys),
``timed``, ``trace_context`` (a torch.profiler Chrome trace, a no-op
without a directory) and the CLI's logger."""

import json
import logging
import os

import torch

from linr_pcgc_tpu.utils.profiling import Timer as JaxTimer
from linr_pcgc_tpu_torch import cli
from linr_pcgc_tpu_torch.utils import Timer, set_logger, timed, trace_context


def test_timer_timed_trace_and_logger(tmp_path, capsys):
    t, jt = Timer(), JaxTimer()
    for timer in (t, jt):
        for _ in range(2):
            with timer.span("a"):
                pass
        with timer.span("b"):
            pass
    got, want = t.summary(), jt.summary()
    assert got.keys() == want.keys() == {"a", "b"}
    for name in got:
        assert got[name].keys() == want[name].keys() == {"total_s", "count", "mean_s"}
        assert got[name]["count"] == want[name]["count"]
        assert got[name]["mean_s"] == got[name]["total_s"] / got[name]["count"]

    lines = []
    with timed("step", log=lines.append):
        pass
    assert len(lines) == 1 and lines[0].startswith("step: ") and lines[0].endswith("s")

    with trace_context(None):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
    trace_dir = tmp_path / "trace"
    with trace_context(str(trace_dir)):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)

    assert cli.set_logger is set_logger
    log = set_logger(str(tmp_path / "info.log"), name="linr_pcgc_tpu_torch.test_utils")
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert (tmp_path / "info.log").read_text() == "hello\n"
    assert "hello" in capsys.readouterr().out
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)
    assert isinstance(log, logging.Logger)
