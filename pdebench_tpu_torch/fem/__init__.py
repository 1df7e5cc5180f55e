from . import assemble, mesh, refelem, sampling, spaces, symbolic  # noqa: F401
from .mesh import Mesh  # noqa: F401
from .spaces import FunctionSpace, vector_space  # noqa: F401
