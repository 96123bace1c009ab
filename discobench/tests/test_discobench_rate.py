"""The window's rule and the rate over a fake clock."""
import pytest

from discobench.harness import reads_per_s, window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def jobs_of(durations, stall_before=None, seconds=30.0):
    clock = FakeClock()
    started = []

    def one(i):
        if stall_before is not None and i == stall_before[0]:
            clock.t += stall_before[1]
        started.append(clock.t)
        clock.t += durations[i]
        return {"t1": clock.t}
    t_open, jobs = window(one, seconds, clock)
    return t_open, jobs, started


def test_the_running_job_ends_and_counts():
    t_open, jobs, started = jobs_of([10.0, 10.0, 25.0, 10.0])
    # jobs start at 0, 10, 20 s; the third runs past 30 s and counts
    assert [s - t_open for s in started] == [0.0, 10.0, 20.0]
    assert reads_per_s(jobs, 1000, t_open) == pytest.approx(3000 / 45.0)


def test_a_stall_between_jobs_counts():
    t_open, jobs, _ = jobs_of([10.0, 10.0, 10.0, 10.0], stall_before=(1, 15))
    # 10 s, a 15 s stall, 10 s (ends at 35 s): two jobs in 35 s
    assert len(jobs) == 2
    assert reads_per_s(jobs, 1000, t_open) == pytest.approx(2000 / 35.0)


def test_a_window_holds_one_job_at_least():
    t_open, jobs, _ = jobs_of([50.0, 10.0], seconds=1.0)
    assert len(jobs) == 1
    assert reads_per_s(jobs, 500, t_open) == pytest.approx(10.0)
