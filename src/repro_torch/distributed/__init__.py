"""The port's distribution layer on ``torch.distributed``: the sharding
rules (``sharding``), the activation constraints (``act``), process groups
and collectives (``comm``), the sharded train step's gathered parameters
(``gather``), GPipe (``pipeline``) and the int8 gradient compression with its
collective (``compression``)."""
