"""Cross-validation over day-keyed recording sessions (the port's own copy
of dss_tpu/utils/cv.py): days are "YYYY_MM_DD" strings, sorted and
optionally rotated so that a chosen day is the first test fold; each fold
yields (train_days: list[str], test_day: str).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple


class LeaveOneDayOut:
    """Yield (train_days, test_day) pairs, one fold per recording day."""

    def split(
        self,
        X: Iterable[str],
        y=None,
        groups=None,
        start_with_day: Optional[str] = None,
    ) -> Iterator[Tuple[List[str], str]]:
        ordered_days = sorted(X)
        if start_with_day is not None:
            if start_with_day not in ordered_days:
                raise ValueError(
                    f"The day {start_with_day} is not in the list of provided "
                    f"days {ordered_days}."
                )
            while ordered_days[0] != start_with_day:
                ordered_days.append(ordered_days.pop(0))

        for i, test_day in enumerate(ordered_days):
            train_days = [d for j, d in enumerate(ordered_days) if j != i]
            yield train_days, test_day

    def get_n_splits(self, X, y=None, groups=None) -> int:
        return len(list(X))
