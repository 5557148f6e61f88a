"""``python -m fire_tpu_torch.bench {headline,gallery,tracker,crowd,profile} [args]``."""

from __future__ import annotations

import importlib
import sys

SUBCOMMANDS = ("headline", "gallery", "tracker", "crowd", "profile")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in SUBCOMMANDS:
        print(f"usage: python -m fire_tpu_torch.bench {{{','.join(SUBCOMMANDS)}}} [args]",
              file=sys.stderr)
        return 2
    return importlib.import_module(f"fire_tpu_torch.bench.{argv[0]}").main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
