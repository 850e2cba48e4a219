"""The profiler helper's handling of sessions whose device records were
lost (``neural_spectral_codec_torch.utils.timing``), with the session
itself stubbed: on the CPU there is no device record to take."""

import pytest

from neural_spectral_codec_torch.utils import timing


@pytest.fixture
def sessions(monkeypatch):
    """Stubs the CUDA check and the profiler session; the sessions
    return the given results in turn and note their calls and pauses."""
    def install(results):
        results = list(results)
        calls = []

        def session(fn, n, lead_in, pause_s):
            calls.append((n, lead_in, pause_s))
            return results.pop(0)

        monkeypatch.setattr(timing, "_check_cuda", lambda: None)
        monkeypatch.setattr(timing, "_profile_device_ops", session)
        monkeypatch.setattr(timing, "REPEATED_SESSIONS", 0)
        monkeypatch.setattr(timing, "LEAD_IN", 8)
        return calls
    return install


@pytest.mark.parametrize("lost", [0, 1, 3, 7])
def test_device_ops_repeats_sessions_that_lost_records(sessions, lost):
    ops = [("kernel_a", 2.0), ("kernel_b", 3.0)]
    calls = sessions([None] * lost + [ops])
    assert timing.device_ops(lambda: None, calls=4) == ops
    assert [n for n, _, _ in calls] == [4] * (lost + 1)
    leads = [lead for _, lead, _ in calls]
    assert leads[0] == 8 and leads == sorted(leads)
    assert leads[-1] <= timing.LEAD_IN_MAX and timing.LEAD_IN == leads[-1]
    pauses = [p for _, _, p in calls]
    assert pauses == sorted(pauses) and pauses[-1] <= 1.0
    assert timing.REPEATED_SESSIONS == lost


def test_device_ops_raises_when_every_session_lost_records(sessions):
    calls = sessions([None] * 8)
    with pytest.raises(timing.RecordsLost):
        timing.device_ops(lambda: None)
    assert len(calls) == 8
    assert calls[-1][1] == timing.LEAD_IN_MAX and timing.LEAD_IN == 8


def test_later_sessions_open_with_the_lead_in_that_held(sessions):
    calls = sessions([None, None, [], []])
    timing.device_ops(lambda: None)
    timing.device_ops(lambda: None)
    assert [lead for _, lead, _ in calls] == [8, 32, 128, 128]


def test_device_ops_keeps_an_empty_record_that_was_not_lost(sessions):
    """A session with both markers and nothing between them: ``fn``
    enqueued nothing, which is an answer, not a lost record."""
    calls = sessions([[]])
    assert timing.device_ops(lambda: None) == []
    assert len(calls) == 1


def test_kernel_device_ms_reads_none_when_records_are_lost(sessions):
    sessions([None] * 8)
    assert timing.kernel_device_ms(lambda: None, ["k"], warmup=0) == (None, 0)


def test_kernel_device_ms_sums_the_named_kernels(sessions):
    sessions([[("k_main(int)", 30.0), ("memset", 5.0), ("k_main(int)", 10.0)]])
    ms, seen = timing.kernel_device_ms(lambda: None, ["k_main"], calls=2,
                                       warmup=0)
    assert seen == 2 and ms == pytest.approx(0.02)
