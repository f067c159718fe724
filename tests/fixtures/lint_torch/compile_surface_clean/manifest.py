"""Every dispatchable (endpoint, bucket) shape has a warm entry."""

LINT_SURFACE = {
    "warmed": [
        "serve.momentum.b1@8x24",
        "serve.momentum.b4@8x24",
        "serve.turnover.b1@8x24",
        "serve.turnover.b4@8x24",
    ],
}
