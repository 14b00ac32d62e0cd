"""The mesh layer of the port: sharding rules and placements, the
collectives over a ``DeviceMesh``'s dims, and the GPipe pipeline."""
