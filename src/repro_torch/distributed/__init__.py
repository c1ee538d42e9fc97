"""Distribution substrate of the port. So far gradient compression
(``compression``), which the train loop uses; sharding, meshes and elastic
restarts come with the distributed slice."""
