"""``python -m ptudes_tpu_torch.cli``: the port's command line."""
import sys

from .main import main

sys.exit(main())
