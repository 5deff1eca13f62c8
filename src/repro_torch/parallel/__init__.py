"""Multi-device serving: sharding rules, the mesh, collectives and the
command loop of a serving mesh's worker ranks."""
