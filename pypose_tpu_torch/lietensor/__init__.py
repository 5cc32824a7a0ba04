from .lietensor import LieTensor, LieType
from .lietensor import SO3_type, so3_type, SE3_type, se3_type
from .lietensor import Sim3_type, sim3_type, RxSO3_type, rxso3_type
from .lietensor import liegroup, liealgebra
from .utils import SO3, so3, SE3, se3, Sim3, sim3, RxSO3, rxso3
from .utils import identity_SO3, identity_so3, identity_SE3, identity_se3
from .utils import identity_Sim3, identity_sim3, identity_RxSO3, \
    identity_rxso3
from .utils import randn_SO3, randn_so3, randn_SE3, randn_se3
from .utils import randn_Sim3, randn_sim3, randn_RxSO3, randn_rxso3
from .utils import randn_like, identity_like
from .utils import Exp, Log, Inv, Mul, Retr, Act, Adj, AdjT, Jinvp, Jr
from .convert import euler2SO3, mat2SO3, mat2SE3, mat2Sim3, mat2RxSO3, \
    from_matrix, tensor, translation, rotation, scale, matrix, euler, \
    quat2unit
from .basics import vec2skew, add, add_, mul, stack, cat, concat, split
