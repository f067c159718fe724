"""The toy warmed manifest: serve.turnover.b4@8x24 is missing — the
fresh-in-window-compile-by-construction hole the rule exists to catch."""

LINT_SURFACE = {
    "warmed": [
        "serve.momentum.b1@8x24",
        "serve.momentum.b4@8x24",
        "serve.turnover.b1@8x24",
    ],
}
