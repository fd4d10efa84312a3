"""dispatch_p95_ms: the 95th percentile, over all the window's dispatches
(one replay of k cycles and its host read), of their host wall time, in
ms (numpy's linear interpolation between order statistics)."""
import numpy as np


def read(rec):
    if not rec.dispatch_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(rec.dispatch_s), 95))
