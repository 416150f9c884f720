"""CLI for the scheme registry: ``python -m repro_torch.api --list-schemes``.

Prints the registry metadata (name, kind, weight law, regime,
resilience) that the ``@register_scheme`` decorators record -- the
table a scheduler (or a human picking ``--scheme``) decides on.  Pure
host-side numpy: it builds no plan and touches no device.  The table is
the JAX package's, text for text.
"""

from __future__ import annotations

import argparse

from .schemes import list_schemes


def format_scheme_table(kind: str | None = None) -> str:
    """The registry as an aligned text table (one row per scheme)."""
    rows = [("name", "kind", "sparse", "resilient", "hetero",
             "weight law", "regime")]
    for info in list_schemes(kind):
        rows.append((info.name, info.kind,
                     "yes" if info.sparse else "no",
                     "yes" if info.straggler_resilient else "NO",
                     "yes" if info.hetero else "no",
                     info.weight, info.regime))
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
             for row in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Introspect the coded-scheme registry.")
    ap.add_argument("--list-schemes", action="store_true",
                    help="print the scheme registry table")
    ap.add_argument("--kind", choices=("mv", "mm"), default=None,
                    help="restrict the table to one scheme kind")
    args = ap.parse_args(argv)
    if not args.list_schemes:
        ap.print_help()
        return 1
    print(format_scheme_table(args.kind))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
