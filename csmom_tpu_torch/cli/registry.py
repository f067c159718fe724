"""``registry list``: inspect the engine registry.

Counterpart of ``csmom_tpu.cli.registry``.  ``registry list`` prints
every registered engine by kind with the surfaces registration bought
it: kind ``serve`` (each endpoint is warmed on the bucket grid, served
and offered by the load generator), kind ``compile`` (each engine's
entries join the warm-up manifests of its profiles, and an entry factory
where it declares one), kind ``strategy`` (the zoo of
``strategy.base.register_strategy``) and kind ``lint`` (the sweep's
rules, each with its scope).  ``--kind`` filters; ``--endpoints`` prints
only the serving tier's endpoint names, one a line, exactly as the
reference does.

``donated`` marks every serve engine and each engine that declares a
``donated_fn``, as in the reference.  What differs: ``sharded`` where an
explicit ``sharded_fn`` is declared or the rule table of
:mod:`csmom_tpu_torch.mesh.variants` resolves one (every serve engine,
through its catch-all serve rule; the reference prints ``sharded:stub``
for every engine without an explicit ``sharded_fn``); a lint rule's row
names its scope (``file`` or ``project``).
"""

from __future__ import annotations

import sys

__all__ = ["cmd_registry", "register"]

def _surfaces(spec) -> str:
    """An engine's surfaces, as the reference names them."""
    from csmom_tpu_torch.mesh.variants import has_sharded

    if spec.kind == "strategy":
        return "-"
    if spec.kind == "lint":
        scope = getattr(spec.rule_cls, "scope", "file")
        return f"lint tier-1 self-test scope:{scope}"
    if spec.kind == "serve":
        out = ["serve", "loadgen"] if spec.workload else ["serve"]
        out.append("donated")  # every serve engine's scorer, donated
    else:
        out = [f"manifest({','.join(spec.profiles)})"]
        if spec.donated_fn is not None:
            out.append("donated")
        if spec.entry_fn is not None:
            out.append("entry")
    if spec.sharded_fn is not None or has_sharded(spec):
        out.append("sharded")
    return " ".join(out)


def cmd_registry(args) -> int:
    """List registered engines and the surfaces registration bought them."""
    from csmom_tpu_torch.registry import (
        engine_specs,
        lint_rules,
        serve_endpoints,
        strategies,
    )

    if args.action != "list":
        print(f"unknown registry action {args.action!r} (try: list)",
              file=sys.stderr)
        return 2
    if args.endpoints:
        for name in serve_endpoints():
            print(name)
        return 0
    n = 0
    for kind in ((args.kind,) if args.kind
                 else ("serve", "compile", "strategy", "lint")):
        # strategies and lint rules register when their modules load
        if kind == "strategy":
            strategies()
        elif kind == "lint":
            lint_rules()
        rows = [(s.name, _surfaces(s), s.description)
                for s in engine_specs(kind)]
        if not rows:
            continue
        print(f"{kind} ({len(rows)}):")
        for name, surfaces, description in rows:
            n += 1
            print(f"  {name:<22} {surfaces}")
            if description and not args.terse:
                print(f"  {'':<22} {description}")
        print()
    print(f"{n} engines registered — one serve registration buys: a warmed "
          "shape on every bucket of the grid, a serve endpoint and a "
          "loadgen workload leg with its per-endpoint books, a donated "
          "scorer and a sharded scorer on a mesh; a compile "
          "registration buys its entries in the warm-up manifests of its "
          "profiles (warmup); a strategy registration buys a --strategy "
          "for the monthly commands; a lint registration buys the lint "
          "sweep, the tier-1 gate and the fixture self-test")
    return 0


def register(sub) -> None:
    """Attach the ``registry`` subparser."""
    sp = sub.add_parser(
        "registry",
        help="inspect the engine registry: every registered engine and "
             "the surfaces registration bought it",
    )
    sp.add_argument("action", nargs="?", default="list",
                    help="what to do (list: print the registry table)")
    sp.add_argument("--kind", choices=["serve", "compile", "strategy",
                                       "lint"],
                    help="only this kind of engine")
    sp.add_argument("--endpoints", action="store_true",
                    help="print only the serve endpoint names (one per "
                         "line)")
    sp.add_argument("--terse", action="store_true",
                    help="omit descriptions (names + surfaces only)")
    sp.set_defaults(fn=cmd_registry)
