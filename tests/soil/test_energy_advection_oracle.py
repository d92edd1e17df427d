"""Independent transient oracle for the coupled energy path.

The reference anchors its *water* physics to external data (Bonan CSV) but
the coupled energy equation — conduction plus the advective internal-energy
flux ``-rho_e_int_l K grad h`` (``right_hand_side.jl:361-365``) — has no
external transient anchor anywhere.  This module supplies one (VERDICT r1
item 6), the energy analogue of ``test_celia_oracle.py``:

- a plain-numpy **implicit** solver: mixed-form Picard (Celia 1990) for
  Richards + backward-Euler conduction with the advective energy flux
  assembled from the converged water fluxes — structurally different from
  the framework's explicit flux-form SSPRK33 path, sharing no code with it
  (closures re-derived here from the published van Genuchten / Balland-Arp
  formulas);
- a sharp warm-water-infiltration-into-cold-soil transient where the
  advective term is decisive: dropping it changes the answer by ~4.5 K RMSE
  (asserted), three orders of magnitude above the agreement tolerance;
- first-order convergence of the oracle toward the framework solution as
  the oracle's dt shrinks — the two discretizations share a limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology import (
    Column,
    Dirichlet,
    FreeDrainage,
    Simulation,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
    initialize_states,
)
from landhydrology.constants import default_earth_param_set as ps
from landhydrology.models.soil import vanGenuchten
from landhydrology.timestepping import SSPRK33

# sand of Haverkamp (Celia config) + warm-water infiltration into cold soil
NU, THETA_R = 0.287, 0.075
VG_N, VG_ALPHA = 3.96, 2.7
VG_M = 1.0 - 1.0/VG_N
KSAT = 34.0/3600.0/100.0
THETA_TOP, THETA_IC = 0.267, 0.10
T_TOP, T_IC = 295.0, 278.0
NZ, ZMIN = 150, -1.5
DZ = -ZMIN/NZ
T_FINAL = 0.8*3600.0
RHO_C_DS = 1.0e6
NU_SS_Q = 0.92
A_BA, B_BA = 0.24, 18.1
KD_PAR = 0.053
RHO_P = 2700.0
K_SOLID = 7.7**NU_SS_Q * 2.5**(1-NU_SS_Q)   # k_solid(om=0, q=0.92, 7.7, 2.5, .25)
K_SAT_UNF = K_SOLID**(1-NU) * 0.57**NU
K_SAT_FR = K_SOLID**(1-NU) * 2.29**NU
RHO_CP_L = ps.rho_cp_l
T0 = ps.T_0
K_AIR = ps.K_therm

def sp():
    return SoilParams(nu=NU, S_s=1e-3, nu_ss_quartz=NU_SS_Q, rho_c_ds=RHO_C_DS,
                      kappa_solid=K_SOLID, kappa_sat_unfrozen=K_SAT_UNF,
                      kappa_sat_frozen=K_SAT_FR, rho_p=RHO_P)

# ---- numpy closures (published formulas, no framework code) ----
def theta_of_h(h):
    se = (1.0 + (VG_ALPHA*np.abs(np.minimum(h,0.0)))**VG_N)**(-VG_M)
    return THETA_R + (NU-THETA_R)*np.where(h<0, se, 1.0)
def cap_of_h(h):
    ah = VG_ALPHA*np.abs(np.minimum(h,-1e-12))
    num = VG_M*VG_N*VG_ALPHA*ah**(VG_N-1.0)
    den = (1.0+ah**VG_N)**(VG_M+1.0)
    return np.where(h<0, (NU-THETA_R)*num/den, 0.0)
def k_of_h(h):
    se = (1.0 + (VG_ALPHA*np.abs(np.minimum(h,0.0)))**VG_N)**(-VG_M)
    se = np.clip(np.where(h<0, se, 1.0), 1e-12, 1.0)
    return KSAT*np.sqrt(se)*(1.0-(1.0-se**(1.0/VG_M))**VG_M)**2
def k_of_theta(th):
    se = np.clip((th-THETA_R)/(NU-THETA_R), 1e-12, 1.0)
    return KSAT*np.sqrt(se)*(1.0-(1.0-se**(1.0/VG_M))**VG_M)**2
def h_of_theta(th):
    se = np.clip((th-THETA_R)/(NU-THETA_R), 1e-9, 1.0-1e-12)
    return -((se**(-1.0/VG_M)-1.0)**(1.0/VG_N))/VG_ALPHA

RHO_B = (1.0-NU)*RHO_P
K_DRY = ((KD_PAR*K_SOLID - K_AIR)*RHO_B + K_AIR*RHO_P)/(RHO_P-(1.0-KD_PAR)*RHO_B)
def kappa_of_theta(th):
    th_l = np.minimum(th, NU)
    S_r = th_l/NU
    Ke = S_r**((1.0 + 0.0 - A_BA*NU_SS_Q - 0.0)/2.0) * \
         ((1.0+np.exp(-B_BA*S_r))**-3 - ((1.0-S_r)/2.0)**3)**1.0
    return Ke*K_SAT_UNF + (1.0-Ke)*K_DRY
def rho_c_s_of(th):
    return RHO_C_DS + np.minimum(th, NU)*RHO_CP_L

def thomas(a,b,c,d):
    n=len(d); cp=np.empty(n); dp=np.empty(n)
    cp[0]=c[0]/b[0]; dp[0]=d[0]/b[0]
    for i in range(1,n):
        m=b[i]-a[i]*cp[i-1]; cp[i]=c[i]/m; dp[i]=(d[i]-a[i]*dp[i-1])/m
    x=np.empty(n); x[-1]=dp[-1]
    for i in range(n-2,-1,-1): x[i]=dp[i]-cp[i]*x[i+1]
    return x

def oracle(dt=2.0, picard_tol=1e-9, max_iter=60, advect=True):
    h = np.full(NZ, h_of_theta(THETA_IC))
    T = np.full(NZ, T_IC)
    theta_n = theta_of_h(h)
    rho_e = rho_c_s_of(theta_n)*(T-T0)
    h_top = float(h_of_theta(THETA_TOP))
    K_top_face = float(k_of_theta(THETA_TOP))   # K at Dirichlet face state (framework semantics)
    for step in range(int(round(T_FINAL/dt))):
        # --- water: mixed-form Picard (implicit) ---
        for _ in range(max_iter):
            K = k_of_h(h); C = cap_of_h(h); theta_m = theta_of_h(h)
            K_int = 0.5*(K[:-1]+K[1:])
            q = np.empty(NZ+1)
            q[1:NZ] = -K_int*((h[1:]-h[:-1])/DZ + 1.0)
            q[NZ] = -K_top_face*((h_top-h[-1])/(0.5*DZ) + 1.0)
            q[0] = -K[0]
            resid = (theta_m-theta_n)/dt + (q[1:]-q[:-1])/DZ
            lo=np.zeros(NZ); up=np.zeros(NZ); di=C/dt
            lo[1:] -= K_int/DZ**2
            up[:-1] -= K_int/DZ**2
            di[1:] += K_int/DZ**2
            di[:-1] += K_int/DZ**2
            di[-1] += K_top_face/(0.5*DZ)/DZ
            dh = thomas(lo,di,up,-resid)
            h = h+dh
            if np.max(np.abs(dh)) < picard_tol: break
        theta_np1 = theta_of_h(h)
        # --- energy: implicit conduction + explicit advection ---
        kap = kappa_of_theta(theta_np1)
        kap_f = 0.5*(kap[:-1]+kap[1:])            # interior faces
        rho_e_l = RHO_CP_L*(T-T0)                 # at T^n (frozen for adv)
        AK = rho_e_l*k_of_theta(theta_np1)
        AK_f = 0.5*(AK[:-1]+AK[1:])
        Fa = np.zeros(NZ+1)
        Fa[1:NZ] = -AK_f*((h[1:]-h[:-1])/DZ + 1.0)
        # boundary faces: SetValue semantics -> conduction-only top, 0 bottom
        adv = -(Fa[1:]-Fa[:-1])/DZ if advect else np.zeros(NZ)
        rc = rho_c_s_of(theta_np1)
        # tridiag in T^{n+1}: rc*(T-T0)/dt - div(kap grad T) = rho_e^n/dt + adv
        lo=np.zeros(NZ); up=np.zeros(NZ); di=rc/dt
        lo[1:] -= kap_f/DZ**2
        up[:-1] -= kap_f/DZ**2
        di[1:] += kap_f/DZ**2
        di[:-1] += kap_f/DZ**2
        # top Dirichlet (half-cell), kappa at face state (theta_c, T_dir) = kappa(theta_c)
        kap_top = kap[-1]
        di[-1] += kap_top/(0.5*DZ)/DZ
        rhs_vec = rho_e/dt + rc*T0/dt + adv
        rhs_vec[-1] += kap_top/(0.5*DZ)/DZ * T_TOP
        T = thomas(lo,di,up,rhs_vec)
        rho_e = rc*(T-T0)
        theta_n = theta_np1
    return theta_of_h(h), T

def framework(dt=0.25):
    hm = vanGenuchten(n=VG_N, alpha=VG_ALPHA, Ksat=KSAT, theta_r=THETA_R)
    model = SoilModel(
        domain=Column(zlim=(ZMIN,0.0), nelements=NZ),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: THETA_TOP),
                                energy=Dirichlet(lambda t: T_TOP)),
            bottom=SoilComponentBC(hydrology=FreeDrainage(), energy=VerticalFlux(0.0))),
        soil_param_set=sp())
    def ic(z, m):
        th = jnp.full_like(z, THETA_IC); ti = jnp.zeros_like(z)
        rc = RHO_C_DS + th*RHO_CP_L
        return {"vartheta_l": th, "theta_i": ti, "rho_e_int": rc*(T_IC - T0)}
    Y, Ya = initialize_states(model, ic, 0.0)
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt,
                     tspan=(0.0, T_FINAL), saveat=T_FINAL)
    sol = sim.run()
    Yf = sol.state(-1)["soil"]
    th = np.asarray(Yf["vartheta_l"])
    rc = RHO_C_DS + np.minimum(th,NU)*RHO_CP_L
    T = T0 + np.asarray(Yf["rho_e_int"])/rc
    return th, T



@pytest.mark.slow
def test_coupled_energy_vs_independent_implicit_oracle():
    """0.8 h of warm-water infiltration into a cold sand column: the
    explicit flux-form framework against the independent implicit numpy
    solver, at the reference coupled tolerance for the water field and
    tight Kelvin-level agreement for temperature."""
    th_f, T_f = framework(dt=0.25)
    th_2, T_2 = oracle(dt=2.0)
    th_h, T_h = oracle(dt=0.5)

    # both codes show the same physics: wet warm top, dry cold bottom
    for th, T in ((th_f, T_f), (th_h, T_h)):
        assert th[-1] > 0.25 and th[0] < 0.11
        assert T[-1] > 288.0 and T[0] < 278.1

    # water field: reference coupled tolerance (coupled.jl:117) and better
    assert float(np.sqrt(np.mean((th_h - th_f) ** 2))) < 1e-3
    # temperature: the schemes agree to a few mK RMSE at oracle dt=0.5
    t_rmse_2 = float(np.sqrt(np.mean((T_2 - T_f) ** 2)))
    t_rmse_h = float(np.sqrt(np.mean((T_h - T_f) ** 2)))
    assert t_rmse_h < 2e-3, t_rmse_h
    # halving the oracle dt shrinks the gap ~linearly: the oracle converges
    # to the framework solution (shared limit), so the residual is the
    # oracle's own O(dt) error, not a physics discrepancy
    assert t_rmse_2 / t_rmse_h > 2.0, (t_rmse_2, t_rmse_h)

    # the advective internal-energy flux is decisive in this transient:
    # dropping it moves the oracle ~4.5 K away (1000x the tolerance), so
    # the agreement above genuinely validates right_hand_side.jl:361-365
    _, T_noadv = oracle(dt=2.0, advect=False)
    assert float(np.sqrt(np.mean((T_noadv - T_f) ** 2))) > 1.0
