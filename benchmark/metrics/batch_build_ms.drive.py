"""The pose-to-batch build of a drive request, in ms: the mean over the
traced window's requests of the host clock around the call into the
program's ``data/synthetic.py::synthetic_batch``, the device synchronised
before and after it."""


def read(r):
    spans = r.spans.get("batch_build")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
