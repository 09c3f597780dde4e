import sys

from blades_tpu_torch.tools.lint.cli import main

sys.exit(main())
