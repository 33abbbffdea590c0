"""The port's device profiling (``ray_tpu_torch.util.profiling``) on the
CPU: a capture writes a Chrome trace holding its annotated spans, a
failure inside the block leaves no profiler running, and captures do not
nest.

``torch.profiler`` allows one active profiler per process, and the
reference's ``jax.profiler`` one trace per process: every test here
leaves the process with no profiler running (checked after each test),
and none runs the reference's ``profile_trace``.
"""

import json

import pytest
import torch

from ray_tpu_torch.util import profiling as tprof

CPU = "cpu"


def _profiler_running():
    return torch._C._autograd._profiler_enabled()


@pytest.fixture(autouse=True)
def _no_profiler_left_running():
    assert not _profiler_running()
    yield
    assert not _profiler_running()


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_holds_the_annotated_span(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.profile_trace(logdir, device=CPU) as out:
        assert out == logdir and _profiler_running()
        with tprof.annotate("ray_tpu_torch_test_span"):
            x = torch.arange(1024.0)
            (x * 2 + 1).sum().item()
    files = tprof.trace_files(logdir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    spans = [e for e in _events(files[0])
             if e.get("name") == "ray_tpu_torch_test_span"]
    assert spans and spans[0]["cat"] == "user_annotation"
    assert spans[0]["dur"] > 0


def test_a_raising_block_stops_the_profiler_and_writes_its_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with pytest.raises(ValueError, match="inside the block"):
        with tprof.profile_trace(logdir, device=CPU):
            with tprof.annotate("before_the_failure"):
                torch.ones(8).sum()
            raise ValueError("inside the block")
    assert not _profiler_running()
    (path,) = tprof.trace_files(logdir)
    assert any(e.get("name") == "before_the_failure" for e in _events(path))
    # The next capture starts cleanly.
    with tprof.profile_trace(logdir, device=CPU):
        torch.ones(8).sum()
    assert len(tprof.trace_files(logdir)) == 2


def test_captures_do_not_nest(tmp_path):
    with tprof.profile_trace(str(tmp_path / "outer"), device=CPU):
        with pytest.raises(RuntimeError, match="already active"):
            with tprof.profile_trace(str(tmp_path / "inner"), device=CPU):
                pass
        # The outer capture is still running and still records.
        assert _profiler_running()
        with tprof.annotate("after_the_refusal"):
            torch.ones(8).sum()
    assert tprof.trace_files(str(tmp_path / "inner")) == []
    (path,) = tprof.trace_files(str(tmp_path / "outer"))
    assert any(e.get("name") == "after_the_refusal" for e in _events(path))


def test_host_tracer_level_is_accepted(tmp_path):
    with tprof.profile_trace(str(tmp_path), host_tracer_level=2,
                             device=CPU):
        torch.ones(4).sum()
    assert len(tprof.trace_files(str(tmp_path))) == 1


def test_trace_files_lists_only_traces(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    for name in ("a/x.pt.trace.json", "a/b/y.pt.trace.json", "a/notes.txt",
                 "z.json"):
        (tmp_path / name).write_text("{}")
    assert tprof.trace_files(str(tmp_path)) == [
        str(tmp_path / "a" / "b" / "y.pt.trace.json"),
        str(tmp_path / "a" / "x.pt.trace.json")]
    assert tprof.trace_files(str(tmp_path / "missing")) == []


def test_defaults_to_the_card_and_refuses_to_fall_back(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tprof.profile_trace(str(tmp_path)):
            pass
    assert tprof.trace_files(str(tmp_path)) == []
