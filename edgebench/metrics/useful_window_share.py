"""useful_window_share: windows the plans transmit over the windows the
padded waves compute before the restoration point, over the waves
dispatched in the measured window.  A wave computes its B bucket's rows
(``ServerModel.batch_bucket``) at its length bucket
(``ServerModel.length_edges``; a full-resolution wave at every window)."""


def read(r):
    sz = r.sizes
    nw_full = (sz["img_size"] // sz["patch_size"]) ** 2 \
        // sz["window_size"] ** 2
    sent = computed = 0
    for w in r.waves:
        sent += sum(w.rows_valid[:w.B])
        computed += w.Bp * (w.lb or nw_full)
    return sent / computed if computed else None
