"""The EasyProtocol envelope the REST answers are wrapped in."""
