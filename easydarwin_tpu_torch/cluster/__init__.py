"""The cluster tier: the EasyProtocol envelope the REST answers are wrapped
in (``protocol``), the Redis client and its in-process fakes
(``redis_client``), leases and presence (``presence``), consistent-hash
placement with fenced claims (``placement``), capacity and load
(``capacity``), the cross-server pull envelope (``pull``), the
service that ties them into lease, claims, checkpoint publication,
migration and admission (``service``), and EasyCMS: the device-management
server (``cms``) with a simulated device and a client (``device``)."""
