"""Native runtime components (C++ with ctypes bindings).

The reference has no native code (SURVEY.md §2: pure Julia); this
package's runtime side uses C++ where host-side throughput matters:

- the asynchronous trajectory sink (``native/trajsink.cpp``) streams saved
  states / checkpoints to disk on a background thread so host IO never
  stalls the device loop;
- the forcing reader (``native/forcingreader.cpp``) mmaps per-column
  forcing time series and prefetches the next window of timesteps while
  the device integrates the current one.
"""

from landhydrology.runtime.forcing import (
    ForcingReader,
    stream_windows,
    write_forcing,
)
from landhydrology.runtime.forcing_driver import (
    make_forced_segment_run,
    run_forced,
)
from landhydrology.runtime.io import (
    TrajectorySink,
    native_available,
    read_trajectory,
)

__all__ = [
    "TrajectorySink",
    "read_trajectory",
    "native_available",
    "ForcingReader",
    "write_forcing",
    "stream_windows",
    "make_forced_segment_run",
    "run_forced",
]
