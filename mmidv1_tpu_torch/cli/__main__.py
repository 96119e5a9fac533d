"""Dispatcher: ``python -m mmidv1_tpu_torch.cli <executable-name> [args...]``."""

import importlib
import sys

from . import COMMANDS


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m mmidv1_tpu_torch.cli <command> [args...]\n")
        print("commands (reference executable names):")
        for name in COMMANDS:
            print(f"  {name}")
        return 0 if argv else 1
    name = argv[0]
    if name not in COMMANDS:
        print(f"unknown command: {name}", file=sys.stderr)
        return 1
    spec = COMMANDS[name]
    module, prefix = spec if isinstance(spec, tuple) else (spec, [])
    mod = importlib.import_module(module)
    return mod.main(prefix + argv[1:])


if __name__ == "__main__":
    sys.exit(main())
