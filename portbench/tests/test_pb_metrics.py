import pytest

from portbench.harness.measure import end_to_end
from portbench.harness.session import PacketLog, SessionLog, window_of
from portbench.harness.spans import Call
from portbench.harness.trace import Trace, host_segments

SEF = bytes([0x12, 0x00, 0x1A, 0x01, 0xC8])   # TD + show-existing slot 4


def _log(times):
    """A session whose frames f are displayed by show-existing packets at
    times[f], 100 bytes each."""
    log = SessionLog()
    log.t0, log.deadline = 10.0, 20.0
    for f, t in enumerate(times):
        log.t_send[f] = t - 0.5
        log.packets.append(PacketLog(SEF + bytes(95), f, "SHOW_EXISTING",
                                     t))
    return log


def test_fps_and_kbit_up_to_the_last_packet():
    log = _log([9.0, 12.0, 14.0, 18.0, 21.0])     # 3 arrive in the window
    win = window_of(log)
    assert win.frames == [1, 2, 3] and win.t_last == 18.0
    m = end_to_end(log, win, 7.5)
    assert m["fps"] == pytest.approx(3 / 8.0)
    assert m["kbit_per_frame"] == pytest.approx(3 * 800 / 3 / 1000)
    assert m["setup_s"] == 7.5


def test_window_closes_at_the_last_whole_shot():
    # shots of 4 frames; frames 2..9 arrive in the window: it counts
    # frames 2..7 (the shot 4..7 is the last that ended in it)
    log = _log([9.0] * 2 + [11.0 + f for f in range(2, 11)] + [25.0])
    win = window_of(log, shot_frames=4)
    assert win.frames == [2, 3, 4, 5, 6, 7] and win.t_last == 18.0
    assert window_of(log).frames == list(range(2, 10))


def test_idle_share_and_gaps_from_a_synthetic_trace():
    tr = Trace()
    tr.t0_ns, tr.t1_ns = 1_000, 11_000
    tr.events = [("k_a", 2_000, 3_000), ("k_b", 2_500, 4_000),
                 ("k_a", 6_000, 7_000), ("memcpy", 10_500, 12_000)]
    assert tr.busy_s() == pytest.approx(3_500e-9)
    assert tr.kernel_seconds(("k_a",)) == (pytest.approx(2e-6), 2)
    assert tr.top_ops()[0] == ["k_a", pytest.approx(2e-6)]
    calls = [Call("pframe", 0.0, 3e-6, 1_500, b"", [], None),
             Call("bframe", 0.0, 1e-6, 8_000, b"", [], None)]
    gaps = dict(tr.idle_by_host(host_segments(calls)))
    # the gaps [1000, 2000), [4000, 6000), [7000, 10500) by their middles:
    # 1500 in pframe [1500, 4500), 5000 after its end, 8750 in bframe
    # [8000, 9000)
    assert gaps == {"pframe": pytest.approx(1e-6),
                    "session": pytest.approx(2e-6),
                    "bframe": pytest.approx(3.5e-6)}


def test_the_profiled_part_of_a_split_window():
    """The stage readers read the calls of the first part of a traced
    window, which carry timings; session_host_ms reads the part after
    the switch to the profiler."""
    from portbench.harness.measure import RunData, reader
    log = _log([9.0, 12.0, 14.0, 18.0, 21.0])
    win = window_of(log)
    calls = [Call("pframe", 11.0, 11.5, 0, b"", [], {"search": 0.25,
                                                     "tile_walk": 0.5}),
             Call("bframe", 12.0, 12.5, 0, b"", [], {"search": 0.5,
                                                     "tile_walk": 0.25}),
             Call("pframe", 13.5, 14.0, 0, b"", [], None),
             Call("bframe", 15.0, 16.0, 0, b"", [], None),
             Call("pframe", 18.5, 19.5, 0, b"", [], None)]
    run = RunData(log, win, calls, None, [], t_switch=13.0)
    shown, start, t_last, inside = run.profiled()
    assert shown == [2, 3] and (start, t_last) == (13.0, 18.0)
    assert len(inside) == 2
    # (18 - 13 - 1.5) s over 2 frames
    assert reader("session_host_ms").read(run) == pytest.approx(1750.0)
    assert reader("tile_walk_ms").read(run) == pytest.approx(375.0)
    assert reader("inter_step_ms").read(run) == pytest.approx(375.0)
