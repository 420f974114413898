"""Interactive terminal settings form (parity: crates/cli/src/tui.rs).

A curses form over the same CLI argument set, mirroring the reference's
ratatui form (tui.rs:16-80 and the field list in the rest of the file):
arrow keys move between fields, left/right cycle enum values (scene,
backend, sampler, output format, command), space toggles AOV/beauty
flags, digits edit numeric fields, Enter opens the scrollable scene
picker on the Scene field or starts the render elsewhere, q/Esc cancels.
Returns the edited argparse namespace, or None on cancel — mirroring
tui::run()'s Option<CommandLineArguments>.
"""
from __future__ import annotations

import curses
from dataclasses import dataclass
from typing import Callable, List, Optional

from .backend import BACKENDS

AOV_GROUPS = ["n", "a", "u", "m"]  # normals, albedo, uv, mip level
AOV_LABELS = {"n": "normals", "a": "albedo", "u": "uv", "m": "mip"}


@dataclass
class _Field:
    label: str
    get: Callable[[], str]
    help: str = ""
    cycle: Optional[Callable[[int], None]] = None   # left/right handler
    edit: Optional[Callable[[str], None]] = None    # text-entry handler
    toggle: Optional[Callable[[], None]] = None     # space handler
    picker: Optional[Callable[[], List[str]]] = None  # Enter -> list overlay
    visible: Callable[[], bool] = lambda: True


def _cycle_list(values, current, d):
    if current not in values:
        return values[0]
    return values[(values.index(current) + d) % len(values)]


def build_form_state(args, scene_names):
    """CLI namespace -> mutable form state (separated for testability)."""
    return {
        "command": getattr(args, "command", None) or "full",
        "scene": args.scene_name or scene_names[0],
        "backend": args.backend,
        "sampler": args.sampler or "independent",
        "spp": str(args.spp or 32),
        "depth": str(args.ray_depth or 8),
        "lights": str(args.light_samples or 4),
        "output": str(args.output or "output.exr"),
        "format": getattr(args, "output_format", None) or "exr",
        "aov": list(args.aov[0].split(",")) if getattr(args, "aov", None)
        else [],
        "beauty": not getattr(args, "no_beauty", False),
        "px": str(getattr(args, "x", 0) or 0),
        "py": str(getattr(args, "y", 0) or 0),
        "count": str(getattr(args, "sample_count", 1) or 1),
    }


def apply_form_state(args, state):
    """Write the edited form state back onto the CLI namespace."""
    from pathlib import Path

    args.command = state["command"]
    args.scene_name = state["scene"]
    args.scene_path = None
    args.backend = state["backend"]
    args.sampler = state["sampler"]
    args.spp = int(state["spp"] or 32)
    args.ray_depth = int(state["depth"] or 8)
    args.light_samples = int(state["lights"] or 4)
    args.output = Path(state["output"] or "output.exr")
    args.output_format = state["format"]
    if state["command"] == "full":
        args.aov = [",".join(state["aov"])] if state["aov"] else None
        args.no_beauty = not state["beauty"]
    else:
        args.x = int(state["px"] or 0)
        args.y = int(state["py"] or 0)
        args.sample_count = int(state["count"] or 1)
        args.sample_offset = 0
    args.interactive = False
    return args


def _toggle_aov(state, g):
    if g in state["aov"]:
        state["aov"].remove(g)
    else:
        state["aov"].append(g)


def run(args):
    """Run the form; returns edited args or None if cancelled."""
    from .scene.test_scenes import all_test_scenes

    scene_names = [s.name for s in all_test_scenes()]
    state = build_form_state(args, scene_names)

    def num_edit(key):
        def apply(ch):
            if ch == "\x7f":
                state[key] = state[key][:-1]
            elif ch.isdigit():
                state[key] += ch
        return apply

    is_full = lambda: state["command"] == "full"      # noqa: E731
    is_pixel = lambda: state["command"] == "pixel"    # noqa: E731

    fields: List[_Field] = [
        _Field("Command", lambda: state["command"],
               help="full-frame render or single-pixel debug",
               cycle=lambda d: state.update(
                   command=_cycle_list(["full", "pixel"], state["command"], d))),
        _Field("Scene", lambda: state["scene"],
               help="Enter opens the scene picker",
               cycle=lambda d: state.update(
                   scene=_cycle_list(scene_names, state["scene"], d)),
               picker=lambda: scene_names),
        _Field("Backend", lambda: state["backend"],
               help="jax = platform default",
               cycle=lambda d: state.update(
                   backend=_cycle_list(list(BACKENDS), state["backend"], d))),
        _Field("Sampler", lambda: state["sampler"],
               help="stratified derives strata = ceil(sqrt(spp))",
               cycle=lambda d: state.update(
                   sampler=_cycle_list(["independent", "stratified"],
                                       state["sampler"], d))),
        _Field("Samples per pixel", lambda: state["spp"], edit=num_edit("spp")),
        _Field("Ray depth", lambda: state["depth"], edit=num_edit("depth")),
        _Field("Light samples", lambda: state["lights"], edit=num_edit("lights")),
        _Field("Output file", lambda: state["output"],
               edit=lambda ch: state.update(
                   output=state["output"][:-1] if ch == "\x7f"
                   else state["output"] + ch
               ), visible=is_full),
        _Field("Output format", lambda: state["format"],
               cycle=lambda d: state.update(
                   format=_cycle_list(["exr", "png"], state["format"], d)),
               visible=is_full),
        *[
            _Field(f"AOV: {AOV_LABELS[g]}",
                   (lambda g=g: "on" if g in state["aov"] else "off"),
                   help="space or arrows toggle this AOV channel group",
                   toggle=(lambda g=g: _toggle_aov(state, g)),
                   cycle=(lambda d, g=g: _toggle_aov(state, g)),
                   visible=is_full)
            for g in AOV_GROUPS
        ],
        _Field("Beauty pass", lambda: "on" if state["beauty"] else "off",
               toggle=lambda: state.update(beauty=not state["beauty"]),
               cycle=lambda d: state.update(beauty=not state["beauty"]),
               visible=is_full),
        _Field("Pixel x", lambda: state["px"], edit=num_edit("px"),
               visible=is_pixel),
        _Field("Pixel y", lambda: state["py"], edit=num_edit("py"),
               visible=is_pixel),
        _Field("Sample count", lambda: state["count"], edit=num_edit("count"),
               visible=is_pixel),
    ]

    result = _run_form(fields, state)
    if not result:
        return None
    return apply_form_state(args, state)


def _scene_picker(stdscr, names, current):
    """Scrollable list overlay (parity: ref scene picker, tui.rs)."""
    sel = names.index(current) if current in names else 0
    top = 0
    h = max(4, min(len(names), curses.LINES - 6))
    while True:
        stdscr.erase()
        stdscr.addstr(0, 2, "select scene (Enter accept, q cancel)",
                      curses.A_BOLD)
        if sel < top:
            top = sel
        if sel >= top + h:
            top = sel - h + 1
        for row, i in enumerate(range(top, min(top + h, len(names)))):
            attr = curses.A_REVERSE if i == sel else curses.A_NORMAL
            stdscr.addstr(2 + row, 4, names[i][:60], attr)
        stdscr.refresh()
        ch = stdscr.getch()
        if ch in (ord("q"), 27):
            return current
        if ch in (curses.KEY_ENTER, 10, 13):
            return names[sel]
        if ch == curses.KEY_UP:
            sel = (sel - 1) % len(names)
        elif ch == curses.KEY_DOWN:
            sel = (sel + 1) % len(names)


def _run_form(fields: List[_Field], state) -> bool:
    def inner(stdscr) -> bool:
        curses.curs_set(0)
        sel = 0
        while True:
            vis = [f for f in fields if f.visible()]
            sel = min(sel, len(vis) - 1)
            stdscr.erase()
            stdscr.addstr(0, 2, "tpu-raytracing — render settings",
                          curses.A_BOLD)
            stdscr.addstr(
                1, 2,
                "↑/↓ select · ←/→ cycle · space toggle · type to edit · "
                "Enter render · q cancel")
            for i, f in enumerate(vis):
                attr = curses.A_REVERSE if i == sel else curses.A_NORMAL
                stdscr.addstr(3 + i, 4, f"{f.label:<20} {f.get():<40}", attr)
            if vis[sel].help:
                stdscr.addstr(4 + len(vis), 4, vis[sel].help, curses.A_DIM)
            stdscr.refresh()
            ch = stdscr.getch()
            if ch in (ord("q"), 27):
                return False
            if ch in (curses.KEY_ENTER, 10, 13):
                f = vis[sel]
                if f.picker:
                    state["scene"] = _scene_picker(
                        stdscr, f.picker(), state["scene"])
                    continue
                return True
            if ch == curses.KEY_UP:
                sel = (sel - 1) % len(vis)
            elif ch == curses.KEY_DOWN:
                sel = (sel + 1) % len(vis)
            elif ch in (curses.KEY_LEFT, curses.KEY_RIGHT):
                if vis[sel].cycle:
                    vis[sel].cycle(1 if ch == curses.KEY_RIGHT else -1)
            elif ch == ord(" ") and vis[sel].toggle:
                vis[sel].toggle()
            elif 0 < ch < 256 and vis[sel].edit:
                vis[sel].edit(chr(ch))

    return curses.wrapper(inner)
