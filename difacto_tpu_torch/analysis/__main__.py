"""``python -m difacto_tpu_torch.analysis`` -> the port's difacto-lint
CLI."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
