"""Small sizes of the two cells, for runs on the CPU."""
SMALL = {
    "ego_16k": dict(host_vertices=384, check_calls=2, traced_calls=4),
    "dd_1178": dict(graphs=10, n_pad=96, nv_max=96, edge_cap=512,
                    tri_cap=512, check_rows=8, check_heaviest=2,
                    check_calls=2, traced_calls=4),
}
