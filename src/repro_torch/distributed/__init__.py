"""Distribution substrate of the port: gradient compression
(``compression``), which the train loop uses; the logical-axis sharding
rules and the ``shard`` annotations of the model code (``sharding``); and
elastic restore of a checkpoint onto a mesh (``elastic``)."""
