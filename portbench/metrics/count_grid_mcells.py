"""Cells of the count loop's grids, in millions, mean per build job: the
program's ``ingest.count_grid_cells`` counter (rows × live terms over the
row batches it launched) over the window. The loop's width: how much grid
each job zeroes, fills and selects from."""


def read(ctx):
    cells = (ctx.get("counters") or {}).get("ingest.count_grid_cells")
    if cells is None or not ctx.get("jobs"):
        return None
    return cells / len(ctx["jobs"]) / 1e6
