"""The binning's radix sorts, in ms a render: the device time in the
traced window of the sort kernels (CUB's radix-sort passes, which
``torch.sort`` runs) over the renders there."""

SORT_KERNELS = ("RadixSort", "radix_sort", "DeviceSegmentedRadixSort")


def read(r):
    calls = r.layer.get("calls", 0)
    seconds = sum(d for n, d in r.kernels
                  if any(k in n for k in SORT_KERNELS))
    if not calls or seconds <= 0:
        return None
    return 1e3 * seconds / calls
