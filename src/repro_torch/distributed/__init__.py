"""Distribution helpers of the port.  Only the int8 gradient compression that
the train step uses is ported (``compression``); the mesh, the sharding
rules and the collectives come with ROADMAP Queue 1 item 12."""
