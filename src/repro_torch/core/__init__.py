"""SparCE core: config, bitmaps, planner, cost model, sparse ops."""
