"""Named-task scheduler driving checkpoint/diagnostics/time-series cadence.

Re-design of the reference's schedule_t (src/app_schedule.hpp:57-196): tasks
carry (num_times_performed, last_performed, is_due); ``mark_tasks`` flags a
task due when ``time - last_performed >= interval`` and advances
last_performed by *exactly* the interval so output cadence never drifts.
The schedule is immutable here (functional updates) and serializes into
checkpoints (see app/serialize.py), matching app_serialize.hpp:69-94.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Mapping


@dataclass(frozen=True)
class Task:
    name: str
    num_times_performed: int = 0
    last_performed: float = 0.0
    is_due: bool = False


@dataclass(frozen=True)
class Schedule:
    tasks: Mapping[str, Task]

    @staticmethod
    def create(*task_names: str) -> "Schedule":
        return Schedule({n: Task(n) for n in task_names})

    def __len__(self):
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks.values())

    def at(self, name: str) -> Task:
        if name not in self.tasks:
            raise KeyError(f"no task scheduled with the name {name}")
        return self.tasks[name]

    def num_times_performed(self, name: str) -> int:
        return self.at(name).num_times_performed

    def last_performed(self, name: str) -> float:
        return self.at(name).last_performed

    def is_due(self, name: str) -> bool:
        return self.at(name).is_due

    def insert(self, task: Task) -> "Schedule":
        d = dict(self.tasks)
        d[task.name] = task
        return Schedule(d)

    def mark_as_due(self, name: str, advance_last_performed_by: float = 0.0):
        t = self.at(name)
        return self.insert(replace(
            t, is_due=True,
            last_performed=t.last_performed + advance_last_performed_by))

    def mark_as_completed(self, name: str) -> "Schedule":
        t = self.at(name)
        return self.insert(replace(
            t, is_due=False, num_times_performed=t.num_times_performed + 1))


def mark_tasks(schedule: Schedule, time: float, task_intervals) -> Schedule:
    """Mark tasks due by elapsed physical time (reference mark_tasks_in,
    app_schedule.hpp:180-196). `task_intervals` is [(name, interval), ...].
    """
    next_schedule = schedule
    for name, interval in task_intervals:
        if time - schedule.last_performed(name) >= interval:
            next_schedule = next_schedule.mark_as_due(name, interval)
    return next_schedule


def run_scheduled_tasks(state, tasks):
    """Run each due task's function over the state in order (reference
    run_scheduled_tasks, app_schedule.hpp:161-174). `tasks` is
    [(name, fn), ...] where fn(state) -> state. Dueness is read from the
    *initial* state's schedule, as in the reference.
    """
    next_state = state
    for name, fn in tasks:
        if state.schedule.is_due(name):
            next_state = fn(next_state)
    return next_state


def complete_task_in(state, name: str):
    """Return state with the named task marked complete (reference
    complete_task_in, app_schedule.hpp:149-155). Works on any state object
    exposing `.schedule` and dataclasses.replace-ability."""
    return replace(state, schedule=state.schedule.mark_as_completed(name))
