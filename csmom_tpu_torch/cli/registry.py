"""``registry list``: inspect the engine registry.

Counterpart of ``csmom_tpu.cli.registry``.  ``registry list`` prints
every registered engine by kind with the surfaces registration bought
it: the port's registry holds kind ``serve`` (each endpoint is warmed on
the bucket grid, served and offered by the load generator) and kind
``compile`` (each engine's entries join the warm-up manifests of its
profiles, and an entry factory where it declares one), and the strategy
zoo (``registry.strategies()``, registered through
``strategy.base.register_strategy``) is listed as kind ``strategy``.
``--kind`` filters; ``--endpoints`` prints only the serving tier's
endpoint names, one a line, exactly as the reference does.

What differs from the reference: a serve engine lists no ``donated``
variant (torch has no buffer donation, ROADMAP.md known difference 12)
and no ``sharded`` hook (the multi-GPU layer, Queue 1 item 7), and a
compile engine lists neither a ``donated`` variant nor a ``sharded``
hook; kind ``lint`` is not ported (item 8d) and exits 2.
"""

from __future__ import annotations

import sys

__all__ = ["cmd_registry", "register"]

# the reference's kinds the port does not have yet, by ROADMAP.md item
_NOT_PORTED = {
    "lint": "8d, lint (lint engines: lint rules)",
}


def _compile_surfaces(spec) -> str:
    """A compile engine's surfaces, as the reference names them."""
    out = [f"manifest({','.join(spec.profiles)})"]
    if spec.entry_fn is not None:
        out.append("entry")
    return " ".join(out)


def cmd_registry(args) -> int:
    """List registered engines and the surfaces registration bought them."""
    from csmom_tpu_torch.registry import engine_specs, serve_endpoints, strategies

    if args.action != "list":
        print(f"unknown registry action {args.action!r} (try: list)",
              file=sys.stderr)
        return 2
    if args.kind in _NOT_PORTED:
        print(f"registry kind {args.kind!r} is not ported yet (ROADMAP.md, "
              f"Queue 1 item {_NOT_PORTED[args.kind]}); the port registers "
              "kinds 'serve', 'compile' and 'strategy'", file=sys.stderr)
        return 2
    if args.endpoints:
        for name in serve_endpoints():
            print(name)
        return 0
    n = 0
    for kind in ((args.kind,) if args.kind else ("serve", "compile", "strategy")):
        if kind == "serve":
            rows = [(s.name, "serve loadgen" if s.workload else "serve",
                     s.description) for s in engine_specs("serve")]
        elif kind == "compile":
            rows = [(s.name, _compile_surfaces(s), s.description)
                    for s in engine_specs("compile")]
        else:
            # a strategy's description: its class docstring's first line
            rows = [(name, "-", (cls.__doc__ or "").strip().split("\n")[0])
                    for name, cls in strategies().items()]
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
          "loadgen workload leg with its per-endpoint books; a compile "
          "registration buys its entries in the warm-up manifests of its "
          "profiles (warmup); a strategy registration buys a --strategy "
          "for the monthly commands")
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
                    help="only this kind of engine (lint is not ported: "
                         "exit 2)")
    sp.add_argument("--endpoints", action="store_true",
                    help="print only the serve endpoint names (one per "
                         "line)")
    sp.add_argument("--terse", action="store_true",
                    help="omit descriptions (names + surfaces only)")
    sp.set_defaults(fn=cmd_registry)
