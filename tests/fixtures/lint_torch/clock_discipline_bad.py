"""Known-bad fixture: the bare wall-clock read plus every alias form a
text search would miss.  Never imported: lint-read only."""

import time
import time as tt
from datetime import datetime
from time import time as _t


def wall_reads():
    a = time.time()               # the bare form
    b = _t()                      # from-import alias: alias hole
    c = tt.time()                 # module alias: alias hole
    d = getattr(time, "time")()   # getattr dodge: alias hole
    indirect = time.time
    e = indirect()                # attribute-aliased rebind: alias hole
    f = datetime.now()            # argless now: wall clock in disguise
    return a + b + c + d + e, f
