"""row_filter_s: seconds a call that the CLI's row loop spends filtering
the sparse rows (the program's rows.filter: utils/filters.CombinedFilter.
mask_row and the masking of each row, summed per row in
cli/consoles._emit_matrix_row), the mean over the window's calls' records.
None where no call wrote a sparse row."""

from portbench import records


def read(run):
    return records.span_mean(run, "rows.filter")
