"""``python -m csmom_tpu_torch.cli``: the port's CLI."""

from csmom_tpu_torch.cli.main import main

raise SystemExit(main())
