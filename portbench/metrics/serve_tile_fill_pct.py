"""Share of the top-k tiles' cells, copied to the card in the window, that
hold a candidate: the workers' ``query.tile_cells_valid`` over
``query.tile_cells``, differenced between the window's start and the
server's stop. The rest is padding to the longest row's power of two."""

from yardstick import telemetry as S


def read(ctx):
    cells = S.window_counter(ctx, "query.tile_cells")
    valid = S.window_counter(ctx, "query.tile_cells_valid")
    if not cells or valid is None:
        return None
    return 100.0 * valid / cells
