"""The EasyProtocol envelope the REST answers are wrapped in
(``protocol``), and the consistent-hash ring and shard-claim keys the
storage tier uses (``placement``)."""
