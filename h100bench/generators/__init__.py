"""The traffic generators: one per kind of traffic, each reading its mixes
from `traffic/<name>.json` (whose `generator` names it)."""
