"""How each family of configurations is built through the program, fed
from the seed and counted. One module a family, found by the
configuration's ``family``."""
