"""``python -m nns_tpu_torch`` runs the benchmark harness (the ./main analog);
``--device cpu`` runs it without a card."""

import sys

from nns_tpu_torch.harness import main

sys.exit(main())
