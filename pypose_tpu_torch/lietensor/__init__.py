from .lietensor import LieTensor, LieType
from .lietensor import SO3_type, so3_type, SE3_type, se3_type
from .lietensor import Sim3_type, sim3_type, RxSO3_type, rxso3_type
from .lietensor import liegroup, liealgebra
from .utils import SO3, so3, SE3, se3
from .utils import identity_SO3, identity_so3, identity_SE3, identity_se3
from .utils import randn_SO3, randn_so3, randn_SE3, randn_se3
from .convert import euler2SO3, mat2SO3, mat2SE3
