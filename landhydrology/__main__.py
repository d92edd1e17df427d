"""``python -m landhydrology`` — config-file simulation driver."""

from landhydrology.cli import main

raise SystemExit(main())
