"""Terminal prompts with injectable IO (port of
`autoposeestimation_tpu/pipeline/tui.py`): numbered selection and
yes/no/quit questions."""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple


def get_selection(name: str, options: Sequence[str], multi: bool = False,
                  add_all: bool = False,
                  input_fn: Callable[[str], str] = input,
                  print_fn: Callable[[str], None] = print):
    """Select one (or several) options by index. Returns a string or a list.

    Multi-select keeps asking until 'd'/'done'; 'a'/'all' selects everything.
    Invalid entries re-prompt. Empty option list returns None/[].
    """
    options = list(options)
    if not options:
        return [] if multi else None
    selected: List[str] = []
    while True:
        print_fn(f"Select {name}:")
        for i, opt in enumerate(options):
            marker = "*" if opt in selected else " "
            print_fn(f" {marker}[{i}] {opt}")
        extras = []
        if multi:
            extras.append("'d'=done")
        if add_all:
            extras.append("'a'=all")
        raw = input_fn(f"choice {' '.join(extras)}> ").strip().lower()
        if multi and raw in ("d", "done"):
            return selected
        if add_all and raw in ("a", "all"):
            return list(options) if multi else options[0]
        try:
            idx = int(raw)
            choice = options[idx]
        except (ValueError, IndexError):
            print_fn("invalid choice")
            continue
        if not multi:
            return choice
        if choice not in selected:
            selected.append(choice)


def get_true_or_false(question: str, default: bool = True,
                      input_fn: Callable[[str], str] = input,
                      print_fn: Callable[[str], None] = print
                      ) -> Tuple[bool, bool]:
    """Returns (answer, move_on): 'q' aborts (move_on=False), empty input
    takes the default — matching get_True_or_False semantics."""
    d = "Y/n" if default else "y/N"
    while True:
        raw = input_fn(f"{question} [{d}] ('q'=quit)> ").strip().lower()
        if raw == "q":
            return default, False
        if raw == "":
            return default, True
        if raw in ("y", "yes", "true", "1"):
            return True, True
        if raw in ("n", "no", "false", "0"):
            return False, True
        print_fn("please answer y/n/q")
