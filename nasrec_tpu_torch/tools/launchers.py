"""The shell launchers under nasrec_tpu_torch/scripts/: the Python commands
each one runs, with its shell variables expanded.

    python -m nasrec_tpu_torch.tools.launchers     # every launcher's commands

The JAX package's launchers under scripts/ have the same form, so the tests
read both with `launcher_commands`, compare their flags and parse the
port's with its CLIs' parsers; to try a launcher with other sizes, append
overrides to its flags (argparse keeps a flag's last value).
"""

from __future__ import annotations

import re
import shlex
from pathlib import Path
from typing import List, Tuple

LAUNCHER_DIR = Path(__file__).resolve().parents[1] / "scripts"

_ASSIGN = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)=(\S*)")
_VAR = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}|\$([A-Za-z_][A-Za-z0-9_]*)")


def launcher_commands(path) -> List[Tuple[str, List[str]]]:
    """(module or script, arguments) of each `python` command of a launcher,
    in order.  `NAME=value` lines (no spaces in the value) set variables that
    `$NAME` and `${NAME}` expand to; any other variable is left as written."""
    variables, commands = {}, []
    for line in Path(path).read_text().replace("\\\n", " ").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        assign = _ASSIGN.fullmatch(line)
        if assign:
            variables[assign[1]] = assign[2]
            continue
        line = _VAR.sub(lambda m: variables.get(m[1] or m[2], m[0]), line)
        words = shlex.split(line)
        if not words or words[0] not in ("python", "python3"):
            continue
        args = [w for w in words[1:] if w != "-u"]
        if args[0] == "-m":
            commands.append((args[1], args[2:]))
        else:
            commands.append((args[0], args[1:]))
    return commands


def launcher_command(path) -> Tuple[str, List[str]]:
    """The one command of a launcher that runs one."""
    commands = launcher_commands(path)
    if len(commands) != 1:
        raise ValueError(f"{path}: {len(commands)} python commands, expected one")
    return commands[0]


def launchers() -> List[Path]:
    return sorted(LAUNCHER_DIR.rglob("*.sh"))


if __name__ == "__main__":
    for p in launchers():
        for module, args in launcher_commands(p):
            print(f"{p.relative_to(LAUNCHER_DIR)}: {module} {' '.join(args)}")
